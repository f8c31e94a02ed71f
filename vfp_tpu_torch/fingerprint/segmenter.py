"""Video segmentation on a fixed-duration grid (port of
``vfp_tpu/fingerprint/segmenter.py``, its frame-exact branch).

Every segment gets exactly round(duration * fps) frames, chunked through the
reader/writer stack, so a leak re-segments onto the marking grid exactly.
Segments are ``segment_NNN.rawv`` (exact uint8 RGB) by default, the files
the HLS workflow and the service mark; ``container="avi"`` writes the JAX
package's no-ffmpeg segments instead, ``segment_NNN.avi`` in MJPEG at
``quality`` (the durability experiment's lossy channel).  No ffmpeg branch
and no audio sidecars.
"""

from __future__ import annotations

import os
from pathlib import Path

from ..io import open_reader, open_writer


def frames_per_segment(fps: float, segment_duration: float) -> int:
    return max(1, int(round(fps * segment_duration)))


def segment_video(input_file, segments_dir, segment_duration: float = 2.0, quality: int = 95,
                  container: str = "rawv"):
    """Split into segment_000.<container>, ... (``rawv`` or ``avi``); returns
    the sorted list of paths."""
    if container not in ("rawv", "avi"):
        raise ValueError(f"segments are .rawv or MJPEG .avi, not .{container}")
    segments_dir = Path(segments_dir)
    segments_dir.mkdir(parents=True, exist_ok=True)
    reader = open_reader(input_file)
    n_per = frames_per_segment(reader.fps, segment_duration)
    paths = []
    idx = 0
    try:
        while True:
            got = 0
            writer = None
            p = segments_dir / f"segment_{idx:03d}.{container}"
            # written under a temporary name and renamed once whole: the ranks
            # of ``hls-mark --distributed`` each segment into one shared
            # directory, and none may read a segment another is rewriting
            tmp = segments_dir / f".{os.getpid()}-{p.name}"
            while got < n_per:
                batch = reader.read_batch(min(16, n_per - got))
                if batch is None:
                    break
                if writer is None:
                    writer = open_writer(tmp, reader.width, reader.height, reader.fps, quality)
                    paths.append(p)
                writer.write_batch(batch)
                got += len(batch)
            if writer is not None:
                writer.close()
                os.replace(tmp, p)
            if got < n_per:
                break
            idx += 1
    finally:
        reader.close()
    return sorted(paths)
