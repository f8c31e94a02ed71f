"""Frame writers: batched sinks of uint8 RGB frames (copied from
``vfp_tpu/io/writers.py``): exact ``.rawv``, MJPEG ``.avi`` and ``.y4m``
(``io/y4m.py``), and, where an ``ffmpeg`` binary is on PATH, the rgb24 pipe
writer for every other suffix (``.mp4`` among them; ``io/ffmpeg.py``).
Without ffmpeg there is no frame writer for ``.mp4``: the JAX package's is
cv2's mp4v encoder; the port's ``.mp4`` files are then box-level remuxes of
MJPEG ``.avi`` samples and audio (``io/mp4.py``).

``MjpegAviWriter`` is the JAX package's self-contained AVI muxer; its
frames are encoded by the native library's JPEG codec (``native/jpeg.py``),
which writes the bytes ``cv2.imencode`` writes, so both packages' files are
equal byte for byte.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

from .readers import RAWV_MAGIC, require_writable


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


class MjpegAviWriter(FrameWriter):
    """Minimal streaming AVI muxer with per-frame JPEG encode.

    Every frame is an independent JPEG at the requested quality: a
    controllable intra-only lossy codec (the attack model for robustness
    testing) that OpenCV and ffmpeg both read back.  A batch's frames are
    encoded on the native codec's thread pool and written in order.
    """

    def __init__(self, file, width: int, height: int, fps: float = 30.0, quality: int = 95):
        self.file = str(file)
        self.width, self.height, self.fps, self.quality = width, height, fps, quality
        self.f = open(self.file, "wb")
        self._index = []  # (offset_in_movi_data, size)
        self._nframes = 0
        self._max_chunk = 0
        # Placeholder header; rewritten on close once counts are known.
        self._write_header(riff_size=0, total_frames=0, movi_size=4)
        self._movi_start = self.f.tell()  # byte after 'movi' fourcc

    # -- RIFF plumbing ------------------------------------------------------
    def _write_header(self, riff_size: int, total_frames: int, movi_size: int):
        f = self.f
        f.seek(0)
        w, h = self.width, self.height
        usec = int(round(1_000_000 / max(self.fps, 1e-6)))
        f.write(b"RIFF" + struct.pack("<I", riff_size) + b"AVI ")
        # hdrl list: avih(56) + strl list
        avih = struct.pack(
            "<14I",
            usec, self._max_chunk * int(self.fps + 1), 0, 0x10 | 0x100,  # HASINDEX|ISINTERLEAVED
            total_frames, 0, 1, max(self._max_chunk, w * h * 3), w, h, 0, 0, 0, 0,
        )
        scale, rate = 1000, int(round(self.fps * 1000))
        strh = (
            b"vids" + b"MJPG"
            + struct.pack("<IHHIIIIIIii4H", 0, 0, 0, 0, scale, rate, 0, total_frames,
                          max(self._max_chunk, w * h * 3), -1, 0, 0, 0, w, h)
        )
        strf = struct.pack("<IiiHH4sIiiII", 40, w, h, 1, 24, b"MJPG", w * h * 3, 0, 0, 0, 0)
        strl = b"LIST" + struct.pack("<I", 4 + 8 + len(strh) + 8 + len(strf)) + b"strl"
        strl += b"strh" + struct.pack("<I", len(strh)) + strh
        strl += b"strf" + struct.pack("<I", len(strf)) + strf
        hdrl_payload = b"avih" + struct.pack("<I", len(avih)) + avih + strl
        f.write(b"LIST" + struct.pack("<I", 4 + len(hdrl_payload)) + b"hdrl" + hdrl_payload)
        f.write(b"LIST" + struct.pack("<I", movi_size) + b"movi")

    def write_batch(self, frames: np.ndarray):
        from ..native.jpeg import encode_jpegs

        f = np.asarray(frames, dtype=np.uint8)
        assert f.shape[1:] == (self.height, self.width, 3), f.shape
        for data in encode_jpegs(f, self.quality):
            self.write_encoded(data)

    def write_encoded(self, data: bytes):
        """Append one already-encoded JPEG as a frame chunk (the stream-copy
        path: io/avi.py splice copies compressed frames with no re-encode)."""
        # RIFF sizes are 32-bit: past 4 GiB the header fields wrap and the
        # file is silently unreadable.  Refuse loudly instead (OpenDML AVIX
        # extension chunks not implemented - segment long outputs upstream).
        projected = (self.f.tell() + 8 + len(data) + 1       # this chunk
                     + 8 + 16 * (self._nframes + 1))         # closing idx1
        if projected > 0xFFFF_F000:
            raise IOError(
                f"{self.file}: AVI RIFF size would exceed 4 GiB at frame "
                f"{self._nframes + 1} - split the output into segments")
        pad = len(data) % 2
        off = self.f.tell() - self._movi_start + 4  # offset from 'movi' fourcc
        self.f.write(b"00dc" + struct.pack("<I", len(data)) + data + b"\x00" * pad)
        self._index.append((off, len(data)))
        self._nframes += 1
        self._max_chunk = max(self._max_chunk, len(data))

    def close(self):
        if self.f.closed:
            return
        movi_end = self.f.tell()
        movi_size = movi_end - self._movi_start + 4  # include 'movi' fourcc
        # idx1
        idx = b"".join(
            b"00dc" + struct.pack("<III", 0x10, off, size) for off, size in self._index
        )
        self.f.write(b"idx1" + struct.pack("<I", len(idx)) + idx)
        riff_size = self.f.tell() - 8
        self._write_header(riff_size, self._nframes, movi_size)
        self.f.close()


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
    """Pick a writer in the JAX package's order: ``.y4m`` 4:2:0, ``.rawv``
    exact (the native write-behind writer where g++ can build it, else the
    pure-Python one), ``.avi`` MJPEG at ``quality``, then, where an
    ``ffmpeg`` binary is on PATH, the rgb24 pipe writer for any other suffix;
    without one any other suffix (``.mp4`` among them) raises ValueError."""
    require_writable(file)
    suffix = Path(file).suffix
    if suffix == ".y4m":
        from .y4m import Y4MWriter

        return Y4MWriter(file, width, height, fps)
    if suffix == ".rawv":
        from ..native import NativeRawVideoWriter, have_native

        if have_native():
            return NativeRawVideoWriter(file, width, height, fps)
        return RawVideoWriter(file, width, height, fps)
    if suffix == ".avi":
        return MjpegAviWriter(file, width, height, fps, quality)
    from .ffmpeg import FFmpegPipeWriter

    return FFmpegPipeWriter(file, width, height, fps)
