"""Lossless 8-bit grayscale PNG through the standard library's ``zlib``: the
image payloads of the ``DtcwtImg`` codec (``cli mark --wm-image``) and the
images ``cli detect --codec dtcwtImg`` recovers.  The JAX CLI reads and
writes these with cv2, which the GPU machine lacks.

The reader takes 8-bit grayscale, non-interlaced PNGs with any of the five
row filters (what cv2 and other encoders write), and raises ``ValueError``
on any other colour type, bit depth or interlacing: cv2 converts a colour
PNG to gray by libpng's own rule, which differs by up to 1 from the integer
BT.601 one, so the port does not guess it.  The writer writes 8-bit
grayscale with no row filter.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png_gray(path, image: np.ndarray) -> None:
    """Write a [H, W] uint8 image as an 8-bit grayscale PNG."""
    img = np.asarray(image)
    if img.ndim != 2 or img.dtype != np.uint8 or 0 in img.shape:
        raise ValueError(f"write_png_gray takes a non-empty [H, W] uint8 image, got "
                         f"{img.dtype} {img.shape}")
    h, w = img.shape
    raw = np.zeros((h, w + 1), np.uint8)  # filter type 0 (None) before each row
    raw[:, 1:] = img
    header = struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0)
    Path(path).write_bytes(PNG_SIGNATURE + _chunk(b"IHDR", header)
                           + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                           + _chunk(b"IEND", b""))


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: np.ndarray, h: int, w: int) -> np.ndarray:
    """Undo the per-row filters of 8-bit single-channel scanlines (one byte
    a pixel, so the left neighbour is the previous byte)."""
    out = np.zeros((h, w), np.uint8)
    prev = np.zeros(w, np.uint8)
    for y in range(h):
        kind, line = raw[y, 0], raw[y, 1:]
        if kind == 0:
            row = line.copy()
        elif kind == 1:  # Sub
            row = np.cumsum(line, dtype=np.uint8)
        elif kind == 2:  # Up
            row = line + prev
        elif kind in (3, 4):  # Average, Paeth: each byte needs its left neighbour
            row = np.zeros(w, np.uint8)
            left = 0
            for x in range(w):
                up = int(prev[x])
                if kind == 3:
                    pred = (left + up) >> 1
                else:
                    pred = _paeth(left, up, int(prev[x - 1]) if x else 0)
                left = (int(line[x]) + pred) & 0xFF
                row[x] = left
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {kind}")
        out[y] = row
        prev = row
    return out


def read_png_gray(path) -> np.ndarray:
    """An 8-bit grayscale, non-interlaced PNG as a [H, W] uint8 array."""
    data = Path(path).read_bytes()
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos: pos + 8])
        body = data[pos + 8: pos + 8 + length]
        crc = data[pos + 8 + length: pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError(f"{path}: truncated {kind!r} chunk")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + body) & 0xFFFFFFFF:
            raise ValueError(f"{path}: bad CRC in the {kind!r} chunk")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + length
    if header is None or not idat:
        raise ValueError(f"{path}: no IHDR or IDAT chunk")
    w, h, depth, color, _, _, interlace = header
    if (depth, color, interlace) != (8, 0, 0):
        raise ValueError(
            f"{path}: vfp_tpu_torch reads 8-bit grayscale non-interlaced PNGs only (this one: "
            f"bit depth {depth}, colour type {color}, interlace {interlace}); convert it to "
            "8-bit gray first")
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (w + 1):
        raise ValueError(f"{path}: image data holds {raw.size} bytes, not {h * (w + 1)}")
    return _unfilter(raw.reshape(h, w + 1), h, w)
