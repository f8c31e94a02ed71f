"""ffmpeg subprocess backend: batched rawvideo pipes + container workflows
(copied from ``vfp_tpu/io/ffmpeg.py``).

The route a host takes where an ``ffmpeg`` binary is on PATH
(``have_ffmpeg``): every container but ``.rawv`` and ``.y4m`` is read through
an rgb24 rawvideo pipe (H.264 titles among them), frames are written to any
suffix but ``.rawv``, ``.avi`` and ``.y4m`` through one, and the HLS
workflow segments, remuxes and splices with ffmpeg.  Without the binary the
port keeps its own containers (``readers.py``, ``writers.py``, ``mp4.py``).
Every command is the JAX module's, argument for argument (reference:
tests/mark_video_to_hls.py:45-71,143-211, tests/generate_leak.py:110-141).

Two differences from the JAX module: a pipe child that exits with a nonzero
code raises IOError at ``close`` (the JAX module ignores the code), and the
reader reads each batch straight into its array (no bytes copy).
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile
from functools import lru_cache
from typing import Optional

import numpy as np

from .probe import probe
from .readers import FrameReader
from .writers import FrameWriter


@lru_cache(maxsize=1)
def have_ffmpeg() -> bool:
    return shutil.which("ffmpeg") is not None


def _require():
    if not have_ffmpeg():
        raise RuntimeError("ffmpeg binary not available")


class FFmpegPipeReader(FrameReader):
    """ffmpeg -i file -f rawvideo -pix_fmt rgb24 pipe: with batched reads.

    A batch is read into one preallocated array.  ``close`` at the end of the
    stream raises IOError if the child failed; ``close`` before the end
    stops the child, whose exit the early close causes."""

    def __init__(self, file):
        _require()
        self.file = str(file)
        info = probe(file)
        self.width, self.height = info["width"], info["height"]
        self.fps = info.get("fps", 30.0)
        self._frame_bytes = self.width * self.height * 3
        self._at_end = False
        self.proc = subprocess.Popen(
            [
                "ffmpeg", "-loglevel", "quiet", "-i", str(file),
                "-f", "rawvideo", "-pix_fmt", "rgb24", "pipe:",
            ],
            stdout=subprocess.PIPE,
        )

    def read_batch(self, n: int) -> Optional[np.ndarray]:
        out = np.empty((n, self.height, self.width, 3), np.uint8)
        view = memoryview(out.reshape(-1))
        got = 0
        while got < len(view) and not self._at_end:
            k = self.proc.stdout.readinto(view[got:])
            if not k:
                self._at_end = True
            got += k or 0
        if not got:
            return None
        k = got // self._frame_bytes
        if k * self._frame_bytes != got:
            raise IOError(f"truncated rawvideo stream from {self.file}")
        return out[:k]

    def close(self):
        if self.proc.stdout.closed:
            return
        self.proc.stdout.close()
        if not self._at_end and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
            return
        rc = self.proc.wait()
        if rc:
            raise IOError(f"ffmpeg exited with code {rc} decoding {self.file}")


class FFmpegPipeWriter(FrameWriter):
    """rawvideo rgb24 pipe -> H.264 yuv420p container (reference default).
    ``close`` raises IOError if the child exits with a nonzero code; a write
    to a child that has gone raises BrokenPipeError."""

    def __init__(self, file, width: int, height: int, fps: float = 30.0, crf: int | None = None):
        _require()
        self.file = str(file)
        self.width, self.height = width, height
        args = [
            "ffmpeg", "-loglevel", "quiet", "-y",
            "-f", "rawvideo", "-pix_fmt", "rgb24", "-s", f"{width}x{height}",
            "-r", f"{fps}", "-i", "pipe:",
            "-pix_fmt", "yuv420p",
        ]
        if crf is not None:
            args += ["-crf", str(crf)]
        args.append(str(file))
        self.proc = subprocess.Popen(args, stdin=subprocess.PIPE)

    def write_batch(self, frames: np.ndarray):
        f = np.ascontiguousarray(frames, dtype=np.uint8)
        if f.shape[1:] != (self.height, self.width, 3):
            raise ValueError(f"frames of {f.shape[1:]} into a {self.width}x{self.height} pipe")
        self.proc.stdin.write(memoryview(f.reshape(-1)))

    def close(self):
        if self.proc.stdin.closed:
            return
        try:
            self.proc.stdin.close()
        finally:
            rc = self.proc.wait()
        if rc:
            raise IOError(f"ffmpeg exited with code {rc} writing {self.file}")


# ---------------------------------------------------------------------------
# Container workflows (segment / HLS / concat)
# ---------------------------------------------------------------------------

def segment_video_ffmpeg(input_file, output_pattern, segment_duration: float = 2.0):
    """Re-encode-segment with forced keyframes at boundaries (reference:
    tests/mark_video_to_hls.py:45-71)."""
    _require()
    subprocess.run(
        [
            "ffmpeg", "-loglevel", "quiet", "-y", "-i", str(input_file),
            "-f", "segment", "-segment_time", str(segment_duration),
            "-reset_timestamps", "1",
            "-force_key_frames", f"expr:gte(t,n_forced*{segment_duration})",
            "-c:v", "libx264", "-preset", "fast", "-c:a", "aac", "-map", "0",
            str(output_pattern),
        ],
        check=True,
    )


def _concat_list(segment_files) -> str:
    """An ffmpeg concat-demuxer list of ``segment_files`` in a temporary file;
    the caller deletes it."""
    with tempfile.NamedTemporaryFile("w", suffix=".txt", delete=False) as f:
        for seg in segment_files:
            f.write(f"file '{os.path.abspath(seg)}'\n")
    return f.name


def concat_mp4_ffmpeg(segment_files, output_file):
    """Stream-copy concat (reference: tests/generate_leak.py:110-141)."""
    _require()
    lst = _concat_list(segment_files)
    try:
        subprocess.run(
            ["ffmpeg", "-loglevel", "quiet", "-y", "-f", "concat", "-safe", "0",
             "-i", lst, "-c", "copy", str(output_file)],
            check=True,
        )
    finally:
        os.unlink(lst)


def segments_to_hls_ffmpeg(segment_files, hls_dir, segment_duration: float = 2.0):
    """Concat-demux marked segments into one fMP4 HLS rendition (reference:
    tests/mark_video_to_hls.py:143-211). Returns (master, playlist)."""
    _require()
    lst = _concat_list(segment_files)
    playlist = os.path.join(str(hls_dir), "playlist.m3u8")
    try:
        subprocess.run(
            [
                "ffmpeg", "-loglevel", "quiet", "-y", "-f", "concat", "-safe", "0",
                "-i", lst,
                "-force_key_frames", f"expr:gte(t,n_forced*{segment_duration})",
                "-c:v", "libx264", "-x264-params", "keyint=48:min-keyint=48",
                "-f", "hls", "-hls_time", str(segment_duration),
                "-hls_segment_type", "fmp4", "-hls_flags", "independent_segments",
                "-hls_segment_filename", os.path.join(str(hls_dir), "segment_%03d.m4s"),
                "-hls_list_size", "0", "-master_pl_name", "master.m3u8",
                playlist,
            ],
            check=True,
        )
    finally:
        os.unlink(lst)
    return os.path.join(str(hls_dir), "master.m3u8"), playlist
