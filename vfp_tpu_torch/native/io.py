"""Frame readers and writers over the native streaming engine (copied from
``vfp_tpu/native/io.py``): ``.rawv`` files, drop-in for the pure-Python
RawVideoReader/Writer, and rawvideo command pipes.  Unlike the JAX classes,
a pipe's ``close`` raises IOError when its command exited nonzero, as the
port's ``io/ffmpeg.py`` pipes do; a reader closed while its command still
runs stops it and does not raise."""

from __future__ import annotations

import ctypes
import struct

import numpy as np

from ..io.readers import RAWV_MAGIC, FrameReader, rawv_frames
from ..io.writers import FrameWriter, rawv_header
from .build import load_vfpio

_HEADER = 24  # RAWV_MAGIC (8) + 4 * u32


class NativeRawVideoReader(FrameReader):
    """.rawv reader with C++ read-ahead."""

    def __init__(self, file, ring: int = 4):
        with open(file, "rb") as f:
            head = f.read(_HEADER)
        if head[:8] != RAWV_MAGIC:
            raise IOError(f"not a VFP raw video file: {file}")
        self.width, self.height, fps_num, fps_den = struct.unpack("<IIII", head[8:])
        self.fps = fps_num / max(fps_den, 1)
        self._frame_bytes = self.width * self.height * 3
        self.n_frames = rawv_frames(file, self._frame_bytes)
        self._source = file
        self._lib = load_vfpio()
        self._h = self._lib.vfpio_reader_open_file(str(file).encode(), self._frame_bytes, ring,
                                                   _HEADER)
        if not self._h:
            raise IOError(f"native reader failed to open {file}")

    def read_batch(self, n: int):
        buf = np.empty(n * self._frame_bytes, np.uint8)
        got = self._lib.vfpio_read_batch(self._h, buf.ctypes.data_as(ctypes.c_char_p), n)
        if got == 0:
            return None
        return buf[: got * self._frame_bytes].reshape(got, self.height, self.width, 3)

    def close(self):
        if self._h:
            rc = self._lib.vfpio_reader_close(self._h)
            self._h = None
            if rc != 0:
                raise IOError(f"native reader: {self._source} exited with code {rc}")


class NativePipeReader(FrameReader):
    """rawvideo-from-command reader (e.g. an ffmpeg decode pipe, ``cmd`` run
    by ``/bin/sh -c``) with C++ read-ahead."""

    def __init__(self, cmd: str, width: int, height: int, fps: float = 30.0, ring: int = 4):
        self.width, self.height, self.fps = width, height, fps
        self._frame_bytes = width * height * 3
        self._source = cmd
        self._lib = load_vfpio()
        self._h = self._lib.vfpio_reader_open_cmd(cmd.encode(), self._frame_bytes, ring)
        if not self._h:
            raise IOError(f"native reader failed to spawn: {cmd}")

    read_batch = NativeRawVideoReader.read_batch
    close = NativeRawVideoReader.close


class NativeRawVideoWriter(FrameWriter):
    """.rawv writer with C++ write-behind."""

    def __init__(self, file, width: int, height: int, fps: float = 30.0, ring: int = 4):
        self.width, self.height = width, height
        with open(file, "wb") as f:
            f.write(rawv_header(width, height, fps))
        self._source = file
        self._lib = load_vfpio()
        self._h = self._lib.vfpio_writer_open_file(str(file).encode(), width * height * 3, ring)
        if not self._h:
            raise IOError(f"native writer failed to open {file}")

    def write_batch(self, frames: np.ndarray):
        f = np.ascontiguousarray(frames, dtype=np.uint8)
        rc = self._lib.vfpio_write_batch(self._h, f.ctypes.data_as(ctypes.c_char_p), len(f))
        if rc < 0:
            raise IOError("native write failed")

    def close(self):
        if self._h:
            rc = self._lib.vfpio_writer_close(self._h)
            self._h = None
            if rc < 0:
                raise IOError("native writer reported an error on close")
            if rc > 0:
                raise IOError(f"native writer: {self._source} exited with code {rc}")


class NativePipeWriter(FrameWriter):
    """rawvideo-to-command writer (e.g. an ffmpeg encode pipe, ``cmd`` run by
    ``/bin/sh -c``) with C++ write-behind."""

    def __init__(self, cmd: str, width: int, height: int, ring: int = 4):
        self.width, self.height = width, height
        self._source = cmd
        self._lib = load_vfpio()
        self._h = self._lib.vfpio_writer_open_cmd(cmd.encode(), width * height * 3, ring)
        if not self._h:
            raise IOError(f"native writer failed to spawn: {cmd}")

    write_batch = NativeRawVideoWriter.write_batch
    close = NativeRawVideoWriter.close
