"""Frame writers: batched sinks of uint8 RGB frames (copied from
``vfp_tpu/io/writers.py``, ``.rawv`` only)."""

from __future__ import annotations

import struct

import numpy as np

from .readers import RAWV_MAGIC, require_rawv


class FrameWriter:
    """Protocol: batched uint8 RGB frame sink."""

    def write_batch(self, frames: np.ndarray):
        raise NotImplementedError

    def write(self, frame: np.ndarray):
        self.write_batch(frame[None])

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class ArrayWriter(FrameWriter):
    """Collects frames in memory (the test seam)."""

    def __init__(self):
        self._chunks = []

    def write_batch(self, frames: np.ndarray):
        self._chunks.append(np.ascontiguousarray(frames, dtype=np.uint8))

    @property
    def frames(self) -> np.ndarray:
        if not self._chunks:
            return np.zeros((0, 0, 0, 3), np.uint8)
        return np.concatenate(self._chunks)


def rawv_header(width: int, height: int, fps: float) -> bytes:
    """The 24-byte ``.rawv`` header: magic, width, height, fps as thousandths."""
    return RAWV_MAGIC + struct.pack("<IIII", width, height, int(round(fps * 1000)), 1000)


class RawVideoWriter(FrameWriter):
    """Exact uint8 RGB transport: 24-byte header + raw frames."""

    def __init__(self, file, width: int, height: int, fps: float = 30.0):
        self.f = open(file, "wb")
        self.width, self.height = width, height
        self.f.write(rawv_header(width, height, fps))

    def write_batch(self, frames: np.ndarray):
        f = np.ascontiguousarray(frames, dtype=np.uint8)
        assert f.shape[1:3] == (self.height, self.width), f.shape
        self.f.write(f.tobytes())

    def close(self):
        self.f.close()


def open_writer(file, width: int, height: int, fps: float = 30.0, quality: int = 95) -> FrameWriter:
    """A ``.rawv`` writer: the native write-behind writer where g++ can build
    it, else the pure-Python one.  ``quality`` is accepted for the CLI's sake;
    ``.rawv`` is lossless."""
    require_rawv(file)
    from ..native import NativeRawVideoWriter, have_native

    if have_native():
        return NativeRawVideoWriter(file, width, height, fps)
    return RawVideoWriter(file, width, height, fps)
