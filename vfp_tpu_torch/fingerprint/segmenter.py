"""Video segmentation on a fixed-duration grid (port of
``vfp_tpu/fingerprint/segmenter.py``).

Where an ``ffmpeg`` binary is on PATH, the JAX module's first route: ffmpeg
re-encodes every source (``.rawv`` among them) into ``segment_NNN.mp4``
with forced keyframes at the boundaries (reference:
tests/mark_video_to_hls.py:45-71) and muxes the source's audio into them
(``-c:a aac -map 0``), so no sidecars are written.  Otherwise, or where the
caller passes ``use_ffmpeg=False``, the frame-exact route: every segment
gets exactly round(duration * fps) frames, chunked through the reader/writer
stack, so a leak re-segments onto the marking grid exactly.  A ``.rawv``
source gives ``segment_NNN.rawv`` segments (exact uint8 RGB); any other
source gives ``segment_NNN.avi`` in MJPEG at ``quality`` (the JAX module's
choice without ffmpeg), and ``container`` forces either.  The source's audio
track, where it has one (an ``.mp4``), is stream-copied into per-segment
sidecars, ``segment_NNN.audio.mp4`` (``io/mp4.py``), which marking, HLS,
leak and download carry along.

Both routes write each segment whole before it takes its name, since the
ranks of ``hls-mark --distributed`` each segment into one shared directory,
and return only the segments of this source, whatever an earlier run left in
the directory.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from pathlib import Path

from ..io import ffmpeg, open_reader, open_writer


def frames_per_segment(fps: float, segment_duration: float) -> int:
    return max(1, int(round(fps * segment_duration)))


def segment_video(input_file, segments_dir, segment_duration: float = 2.0,
                  use_ffmpeg: bool | None = None, quality: int = 95, *,
                  container: str | None = None):
    """Split into segment_000.<ext>, ... and return the sorted list of
    segment paths.  ``use_ffmpeg`` (by default: an ``ffmpeg`` binary is on
    PATH) takes the ffmpeg route to ``.mp4`` segments; otherwise the
    frame-exact route writes ``container`` segments (``rawv`` or ``avi``; by
    default ``rawv`` for a ``.rawv`` source and ``avi`` for any other) and
    the audio sidecars.  ``container`` names the frame route's segments
    only: a caller that pins it pins ``use_ffmpeg=False`` as well."""
    if use_ffmpeg is None:
        use_ffmpeg = ffmpeg.have_ffmpeg()
    segments_dir = Path(segments_dir)
    segments_dir.mkdir(parents=True, exist_ok=True)
    if use_ffmpeg:
        return _segment_ffmpeg(input_file, segments_dir, segment_duration)
    if container is None:
        container = "rawv" if Path(input_file).suffix == ".rawv" else "avi"
    if container not in ("rawv", "avi"):
        raise ValueError(f"segments are .rawv or MJPEG .avi, not .{container}")
    reader = open_reader(input_file)
    n_per = frames_per_segment(reader.fps, segment_duration)
    fps = reader.fps
    paths = []
    idx = 0
    try:
        while True:
            got = 0
            writer = None
            p = segments_dir / f"segment_{idx:03d}.{container}"
            tmp = _temp_name(p)
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
    _write_audio_sidecars(input_file, paths, n_per, fps)
    return sorted(paths)


def _segment_ffmpeg(input_file, segments_dir: Path, segment_duration: float):
    """ffmpeg's segmenter into a private directory, then each segment renamed
    into ``segments_dir``: ffmpeg rewrites its outputs in place, and another
    rank may be reading a segment of the same name."""
    private = Path(tempfile.mkdtemp(prefix=f".ffmpeg-{os.getpid()}-", dir=segments_dir))
    try:
        ffmpeg.segment_video_ffmpeg(
            input_file, str(private / "segment_%03d.mp4"), segment_duration
        )
        paths = []
        for f in sorted(private.glob("segment_*.mp4")):
            os.replace(f, segments_dir / f.name)
            paths.append(segments_dir / f.name)
        return paths
    finally:
        shutil.rmtree(private, ignore_errors=True)


def _temp_name(path: Path) -> Path:
    """Where ``path`` is written before it is renamed into place, once whole:
    the ranks of ``hls-mark --distributed`` each segment into one shared
    directory, and none may read a file another is rewriting.  The suffix is
    kept, since it picks the writer."""
    return path.with_name(f".{os.getpid()}-{path.name}")


def _write_audio_sidecars(input_file, segment_paths, n_per: int, fps: float):
    """Stream-copy the source's audio into per-segment sidecar files.

    Segments carry no audio, so the audio slice for segment i (time range
    [i, i+1) * n_per/fps, matching the frame-exact video grid) rides in
    ``segment_i.audio.mp4`` and is muxed back by the splice/download paths
    (io/mp4.py audio_sidecar).  No-op when the source has no parseable
    audio track (non-MP4 input, video-only file)."""
    try:
        from ..io.mp4 import audio_sidecar, read_mp4, slice_track_by_time, write_mp4

        audio = read_mp4(input_file).audio()
    except Exception:
        return
    if audio is None or not audio.samples or not fps:
        return
    seg_seconds = n_per / fps
    for i, seg in enumerate(segment_paths):
        part = slice_track_by_time(audio, i * seg_seconds, (i + 1) * seg_seconds)
        if part.samples:
            sidecar = audio_sidecar(seg)
            tmp = _temp_name(sidecar)
            write_mp4(tmp, [part])
            os.replace(tmp, sidecar)
