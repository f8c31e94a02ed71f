"""Frame readers: batched sources of uint8 RGB frames (copied from
``vfp_tpu/io/readers.py``): exact ``.rawv``, MJPEG ``.avi``, MJPEG-in-MP4
``.mp4``/``.m4s`` and YUV4MPEG2 ``.y4m`` (``io/y4m.py``), and the dispatch
that sends every other container through an ffmpeg pipe where the binary is
on PATH (``open_reader``; ``io/ffmpeg.py``).

``read_batch(n) -> [k, H, W, 3] | None`` lets the pipeline feed the device
whole batches while the next one is read.  ``MjpegAviReader`` and
``Mp4MjpegReader`` stand where the JAX package's ``Cv2Reader`` reads
``.avi`` and ``.mp4`` without ffmpeg: they decode each JPEG sample as
``cv2.imdecode`` does (the native library's codec), not as cv2's FFmpeg
backend does.  Without ffmpeg an MP4 whose video is not JPEG (``mp4v``,
``avc1``, ...) raises IOError: the port has no decoder for inter-frame
video of its own.
"""

from __future__ import annotations

import itertools
import os
import struct
from pathlib import Path
from typing import Optional

import numpy as np

RAWV_MAGIC = b"VFPRAWV1"


class FrameReader:
    """Protocol: batched uint8 RGB frame source."""

    width: int
    height: int
    fps: float = 30.0
    n_frames: Optional[int] = None  # the frames in the stream, where the header says


    def read_batch(self, n: int) -> Optional[np.ndarray]:
        """Up to n frames as uint8 [k, H, W, 3] (RGB); None at end of stream."""
        raise NotImplementedError

    def read(self) -> Optional[np.ndarray]:
        """Single frame [H, W, 3] or None."""
        b = self.read_batch(1)
        return None if b is None else b[0]

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class ArrayReader(FrameReader):
    """In-memory source (the test seam)."""

    def __init__(self, frames: np.ndarray, fps: float = 30.0):
        assert frames.ndim == 4 and frames.shape[-1] == 3
        self.frames = np.ascontiguousarray(frames, dtype=np.uint8)
        self.height, self.width = frames.shape[1:3]
        self.fps = fps
        self.n_frames = len(self.frames)
        self._pos = 0

    def read_batch(self, n: int) -> Optional[np.ndarray]:
        if self._pos >= len(self.frames):
            return None
        out = self.frames[self._pos : self._pos + n]
        self._pos += len(out)
        return out


def rawv_frames(file, frame_bytes: int) -> int:
    """The whole frames after a ``.rawv`` file's 24-byte header."""
    body = os.path.getsize(file) - 24
    return body // frame_bytes if frame_bytes else 0


class RawVideoReader(FrameReader):
    """Reader for the exact-transport raw format written by RawVideoWriter."""

    def __init__(self, file):
        self.f = open(file, "rb")
        magic = self.f.read(8)
        if magic != RAWV_MAGIC:
            self.f.close()
            raise IOError(f"not a VFP raw video file: {file}")
        self.width, self.height, fps_num, fps_den = struct.unpack("<IIII", self.f.read(16))
        self.fps = fps_num / max(fps_den, 1)
        self._frame_bytes = self.width * self.height * 3
        self.n_frames = rawv_frames(file, self._frame_bytes)

    def read_batch(self, n: int) -> Optional[np.ndarray]:
        buf = self.f.read(self._frame_bytes * n)
        if not buf:
            return None
        k = len(buf) // self._frame_bytes
        if k * self._frame_bytes != len(buf):
            raise IOError("truncated raw video file")
        return np.frombuffer(buf, np.uint8).reshape(k, self.height, self.width, 3)

    def close(self):
        self.f.close()


class MjpegAviReader(FrameReader):
    """MJPEG ``.avi`` reader: fps and dimensions from the AVI header, each
    frame's JPEG decoded by the native codec, a batch's frames on its thread
    pool, in order.  A file that is not an MJPEG AVI, a truncated one or a
    JPEG the codec refuses raises IOError."""

    def __init__(self, file):
        from .avi import avi_meta, iter_video_chunks

        self.file = str(file)
        meta = avi_meta(file)
        if not meta["mjpeg"]:
            raise IOError(f"not an MJPEG AVI: {file}")
        self.width, self.height = meta["width"], meta["height"]
        if self.width <= 0 or self.height <= 0:
            raise IOError(f"invalid AVI dims {self.width}x{self.height}: {file}")
        self.fps = meta["fps"] or 30.0
        self.n_frames = meta["frames"]
        self._chunks = iter_video_chunks(file)

    def read_batch(self, n: int) -> Optional[np.ndarray]:
        from ..native.jpeg import decode_jpegs

        chunks = list(itertools.islice(self._chunks, n))
        if not chunks:
            return None
        return decode_jpegs(chunks, self.height, self.width)

    def close(self):
        self._chunks.close()


class Mp4MjpegReader(FrameReader):
    """MJPEG-in-MP4 reader (``.mp4`` or fragmented ``.m4s``): the sample
    spans of the video track from ``io/mp4.py:read_mp4``, each sample's JPEG
    decoded by the native codec, a batch's frames on its thread pool, in
    order.  Width and height come from the track's sample entry (its
    presentation size where the entry has none) and fps from the first
    sample's duration.  A file with no video track, a video track whose
    codec is not ``jpeg``, or a JPEG the codec refuses raises IOError."""

    def __init__(self, file):
        from .mp4 import read_mp4

        self.file = str(file)
        video = read_mp4(file).video()
        if video is None or not video.samples:
            raise IOError(f"no video samples in {file}")
        fourcc = video.codec_fourcc()
        if fourcc != b"jpeg":
            name = fourcc.decode("latin-1")
            raise IOError(f"{file}: the video track is {name!r}; vfp_tpu_torch decodes "
                          f"MJPEG ('jpeg') MP4 video only and has no decoder for {name!r}")
        self.width, self.height = _visual_entry_size(video)
        if self.width <= 0 or self.height <= 0:
            raise IOError(f"invalid MP4 video dims {self.width}x{self.height}: {file}")
        first = video.samples[0].duration
        self.fps = video.timescale / first if first and video.timescale else 30.0
        self._samples = video.samples
        self.n_frames = len(video.samples)
        self._pos = 0
        self._f = open(self.file, "rb")

    def read_batch(self, n: int) -> Optional[np.ndarray]:
        from ..native.jpeg import decode_jpegs

        batch = self._samples[self._pos : self._pos + n]
        if not batch:
            return None
        self._pos += len(batch)
        chunks = []
        for s in batch:
            if s.data is not None:
                chunks.append(s.data)
                continue
            self._f.seek(s.offset)
            data = self._f.read(s.size)
            if len(data) != s.size:
                raise IOError(f"truncated sample in {self.file}")
            chunks.append(data)
        return decode_jpegs(chunks, self.height, self.width)

    def close(self):
        self._f.close()


def _visual_entry_size(track) -> tuple[int, int]:
    """(width, height) of a video track: its VisualSampleEntry's fields
    (stsd header 16 bytes, entry header 8, then 24 bytes before them), else
    the tkhd presentation size."""
    stsd = track.stsd
    if len(stsd) >= 52:
        w, h = struct.unpack_from(">HH", stsd, 48)
        if w and h:
            return w, h
    return int(track.width), int(track.height)


READ = (".rawv", ".avi", ".mp4", ".m4s", ".y4m")
WRITE = (".rawv", ".avi", ".y4m")


def _have_ffmpeg() -> bool:
    from . import ffmpeg

    return ffmpeg.have_ffmpeg()


def _refuse(file, kinds, verb: str) -> None:
    suffix = Path(file).suffix
    if suffix not in kinds:
        raise ValueError(
            f"{file}: vfp_tpu_torch {verb} {', '.join(kinds)} files only, not "
            f"{suffix or 'a file without a suffix'} (.rawv exact, .avi and .mp4/.m4s MJPEG, "
            ".y4m 4:2:0), unless an ffmpeg binary is on PATH")


def require_supported(file) -> None:
    """Raise ``ValueError`` unless the port reads ``file``'s container.  With
    an ``ffmpeg`` binary on PATH every suffix is read (through the pipe, all
    but ``.rawv`` and ``.y4m``); without one: ``.rawv``, MJPEG ``.avi``,
    MJPEG-in-MP4 ``.mp4``/``.m4s`` or ``.y4m``."""
    if not _have_ffmpeg():
        _refuse(file, READ, "reads")


def require_writable(file) -> None:
    """Raise ``ValueError`` unless the port writes ``file``'s container.  With
    an ``ffmpeg`` binary on PATH every suffix is written (``.mp4`` among
    them, through the pipe writer); without one: ``.rawv``, MJPEG ``.avi``
    or ``.y4m``.  ``.mp4`` is then refused: the JAX package writes it with
    cv2's mp4v encoder, which the port has not (its ``.mp4`` files are
    remuxes, ``io/mp4.py``)."""
    if not _have_ffmpeg():
        _refuse(file, WRITE, "writes frames to")


def open_reader(file) -> FrameReader:
    """Pick a reader in the JAX package's order: ``.y4m``, then ``.rawv``,
    then, where an ``ffmpeg`` binary is on PATH, the rgb24 pipe
    (``io/ffmpeg.py``) for every other suffix; without one, the port's own
    readers."""
    if Path(file).suffix not in (".rawv", ".y4m") and _have_ffmpeg():
        from .ffmpeg import FFmpegPipeReader

        return FFmpegPipeReader(file)
    return _open_own_reader(file)


def _open_own_reader(file) -> FrameReader:
    """The port's own reader of ``file``, whether or not ffmpeg is on PATH:
    ``.rawv`` (the native read-ahead reader where g++ can build it, else the
    pure-Python one), MJPEG ``.avi``, MJPEG-in-MP4 ``.mp4``/``.m4s``, or
    ``.y4m``; any other suffix raises ValueError."""
    _refuse(file, READ, "reads")
    suffix = Path(file).suffix
    if suffix == ".avi":
        return MjpegAviReader(file)
    if suffix in (".mp4", ".m4s"):
        return Mp4MjpegReader(file)
    if suffix == ".y4m":
        from .y4m import Y4MReader

        return Y4MReader(file)
    from ..native import NativeRawVideoReader, have_native

    if have_native():
        return NativeRawVideoReader(file)
    return RawVideoReader(file)
