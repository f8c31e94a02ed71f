"""Frame readers: batched sources of uint8 RGB frames (copied from
``vfp_tpu/io/readers.py``): exact ``.rawv`` and MJPEG ``.avi``.

``read_batch(n) -> [k, H, W, 3] | None`` lets the pipeline feed the device
whole batches while the next one is read.  ``MjpegAviReader`` stands where
the JAX package's ``Cv2Reader`` reads ``.avi``: it decodes each JPEG chunk
as ``cv2.imdecode`` does (the native library's codec), not as cv2's FFmpeg
backend does.
"""

from __future__ import annotations

import itertools
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
        self._pos = 0

    def read_batch(self, n: int) -> Optional[np.ndarray]:
        if self._pos >= len(self.frames):
            return None
        out = self.frames[self._pos : self._pos + n]
        self._pos += len(out)
        return out


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
        self._chunks = iter_video_chunks(file)

    def read_batch(self, n: int) -> Optional[np.ndarray]:
        from ..native.jpeg import decode_jpegs

        chunks = list(itertools.islice(self._chunks, n))
        if not chunks:
            return None
        return decode_jpegs(chunks, self.height, self.width)

    def close(self):
        self._chunks.close()


SUPPORTED = (".rawv", ".avi")


def require_supported(file) -> None:
    """Raise unless ``file`` is a ``.rawv`` or an ``.avi`` path: the port reads
    and writes exact ``.rawv`` and MJPEG ``.avi`` and no other container
    (``.mp4`` needs an inter-frame encoder the port has not, ``.y4m`` is lossy
    4:2:0)."""
    suffix = Path(file).suffix
    if suffix not in SUPPORTED:
        raise ValueError(f"{file}: vfp_tpu_torch reads and writes .rawv and MJPEG .avi files "
                         f"only, not {suffix or 'a file without a suffix'}; convert other "
                         "containers with vfp_tpu.io")


def require_rawv(file) -> None:
    """Raise unless ``file`` is a ``.rawv`` path: the service takes exact
    uploads and leaks only."""
    if Path(file).suffix != ".rawv":
        raise ValueError(f"{file}: the service takes .rawv files only (exact uint8 RGB); "
                         "convert other containers with vfp_tpu.io")


def open_reader(file) -> FrameReader:
    """Pick a reader: ``.rawv`` (the native read-ahead reader where g++ can
    build it, else the pure-Python one) or MJPEG ``.avi``."""
    require_supported(file)
    if str(file).endswith(".avi"):
        return MjpegAviReader(file)
    from ..native import NativeRawVideoReader, have_native

    if have_native():
        return NativeRawVideoReader(file)
    return RawVideoReader(file)
