"""Frame readers: batched sources of uint8 RGB frames (copied from
``vfp_tpu/io/readers.py``, ``.rawv`` only).

``read_batch(n) -> [k, H, W, 3] | None`` lets the pipeline feed the device
whole batches while the next one is read.
"""

from __future__ import annotations

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


def require_rawv(file) -> None:
    """Raise unless ``file`` is a ``.rawv`` path: the port reads and writes no
    other container (the others need cv2 or ffmpeg, and ``.y4m`` is lossy 4:2:0)."""
    if Path(file).suffix != ".rawv":
        raise ValueError(f"{file}: vfp_tpu_torch reads and writes .rawv files only "
                         "(exact uint8 RGB); convert other containers with vfp_tpu.io")


def open_reader(file) -> FrameReader:
    """A ``.rawv`` reader: the native read-ahead reader where g++ can build it,
    else the pure-Python one."""
    require_rawv(file)
    from ..native import NativeRawVideoReader, have_native

    if have_native():
        return NativeRawVideoReader(file)
    return RawVideoReader(file)
