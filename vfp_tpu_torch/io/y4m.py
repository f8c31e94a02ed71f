"""YUV4MPEG2 (``.y4m``) reader and writer, the standard raw-video interchange
format (what ``ffmpeg -f yuv4mpegpipe`` writes); copied from
``vfp_tpu/io/y4m.py``, byte for byte and pixel for pixel.

Frames are stored planar YUV 4:2:0 with C420jpeg (full-range, centred)
chroma siting: the float cv2 colour constants (``ops/color.py``) scaled to
the 0..255 plane convention, chroma downsampled by a 2x2 mean and upsampled
by cv2's float32 INTER_LINEAR (``ops/filters.py:resize_linear``, which
equals ``cv2.resize`` bit for bit).  The chroma round trip is lossy: a
realistic 4:2:0 attack surface, and the exact format other tools exchange.
"""

from __future__ import annotations

import numpy as np

from ..ops.color import M_BWD, M_FWD, OFF_FWD
from ..ops.filters import resize_linear
from .readers import FrameReader
from .writers import FrameWriter

_MAGIC = b"YUV4MPEG2"


def _to8(x: np.ndarray) -> np.ndarray:
    return np.clip(np.round(x), 0, 255).astype(np.uint8)


def _rgb_to_y4m_planes(frame: np.ndarray):
    """uint8 RGB [H, W, 3] -> (Y, U, V) uint8 planes, U/V half-res."""
    f = frame.astype(np.float32)
    # file-order RGB -> the float constants expect [B, G, R] channel order
    b, g, r = f[..., 2], f[..., 1], f[..., 0]
    y = M_FWD[0, 0] * b + M_FWD[0, 1] * g + M_FWD[0, 2] * r
    u = M_FWD[1, 0] * b + M_FWD[1, 1] * g + M_FWD[1, 2] * r + OFF_FWD[1] * 255.0
    v = M_FWD[2, 0] * b + M_FWD[2, 1] * g + M_FWD[2, 2] * r + OFF_FWD[2] * 255.0

    def sub(c):
        return 0.25 * (c[0::2, 0::2] + c[0::2, 1::2] + c[1::2, 0::2] + c[1::2, 1::2])

    return _to8(y), _to8(sub(u)), _to8(sub(v))


def _y4m_planes_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    h, w = y.shape
    uf = resize_linear(u.astype(np.float32), (h, w))
    vf = resize_linear(v.astype(np.float32), (h, w))
    yf = y.astype(np.float32)
    du = uf - 127.5
    dv = vf - 127.5
    b = M_BWD[0, 0] * yf + M_BWD[0, 1] * du + M_BWD[0, 2] * dv
    g = M_BWD[1, 0] * yf + M_BWD[1, 1] * du + M_BWD[1, 2] * dv
    r = M_BWD[2, 0] * yf + M_BWD[2, 1] * du + M_BWD[2, 2] * dv
    return _to8(np.stack([r, g, b], axis=-1))


class Y4MReader(FrameReader):
    """A 4:2:0 ``.y4m`` file's frames as uint8 RGB.  A file that is not
    YUV4MPEG2, another chroma mode, a header without W or H, or a frame
    without its ``FRAME`` marker raises IOError."""

    def __init__(self, file):
        self.f = open(file, "rb")
        header = self.f.readline().strip()
        try:
            if not header.startswith(_MAGIC):
                raise IOError(f"not a y4m file: {file}")
            self.width = self.height = None
            self.fps = 30.0
            for tok in header.split()[1:]:
                tag, val = chr(tok[0]), tok[1:].decode()
                if tag == "W":
                    self.width = int(val)
                elif tag == "H":
                    self.height = int(val)
                elif tag == "F":
                    num, den = val.split(":")
                    self.fps = int(num) / max(int(den), 1)
                elif tag == "C" and not val.startswith("420"):
                    raise IOError(f"unsupported y4m chroma mode: {val}")
            if not self.width or not self.height:
                raise IOError("y4m header missing W/H")
        except BaseException:
            self.f.close()
            raise
        self._frame_bytes = self.width * self.height * 3 // 2

    def read_batch(self, n: int):
        h, w = self.height, self.width
        out = []
        for _ in range(n):
            line = self.f.readline()
            if not line:
                break
            if not line.startswith(b"FRAME"):
                raise IOError(f"bad y4m frame marker: {line[:20]!r}")
            buf = self.f.read(self._frame_bytes)
            if len(buf) < self._frame_bytes:
                break
            raw = np.frombuffer(buf, np.uint8)
            y = raw[: h * w].reshape(h, w)
            u = raw[h * w : h * w + h * w // 4].reshape(h // 2, w // 2)
            v = raw[h * w + h * w // 4 :].reshape(h // 2, w // 2)
            out.append(_y4m_planes_to_rgb(y, u, v))
        if not out:
            return None
        return np.stack(out)

    def close(self):
        self.f.close()


class Y4MWriter(FrameWriter):
    """uint8 RGB frames -> a ``C420jpeg`` ``.y4m`` file (even dimensions)."""

    def __init__(self, file, width: int, height: int, fps: float = 30.0):
        if width % 2 or height % 2:
            raise ValueError("y4m 4:2:0 requires even dimensions")
        self.width, self.height = width, height
        self.f = open(file, "wb")
        num = int(round(fps * 1000))
        self.f.write(
            f"YUV4MPEG2 W{width} H{height} F{num}:1000 Ip A0:0 C420jpeg\n".encode()
        )

    def write_batch(self, frames: np.ndarray):
        for frame in np.ascontiguousarray(frames, dtype=np.uint8):
            y, u, v = _rgb_to_y4m_planes(frame)
            self.f.write(b"FRAME\n")
            self.f.write(y.tobytes())
            self.f.write(u.tobytes())
            self.f.write(v.tobytes())

    def close(self):
        self.f.close()
