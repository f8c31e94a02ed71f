"""PNG through the standard library's ``zlib``, and the one-image reader of
``cli test-frame``.  The JAX CLI reads and writes images with cv2, which the
GPU machine lacks.

The image payloads of the ``DtcwtImg`` codec (``cli mark --wm-image``) and
the images ``cli detect --codec dtcwtImg`` recovers are 8-bit grayscale
PNGs: ``read_png_gray`` raises ``ValueError`` on any other colour type, bit
depth or interlacing, since cv2 converts a colour PNG to gray by libpng's
own rule, which differs by up to 1 from the integer BT.601 one, so the port
does not guess it.  ``read_image_bgr`` reads a picture as
``cv2.imread(path, IMREAD_COLOR)`` does: an 8-bit gray (replicated), gray
with alpha, RGB or RGBA (alpha dropped) PNG, or a baseline JPEG through the
port's decoder, to BGR.  ``read_image_gray`` reads the watermark images of
``--wm-image`` as ``cv2.imread(path, IMREAD_GRAYSCALE)`` does: the gray
channel of a gray or gray + alpha PNG, libpng's fixed-point rgb-to-gray of
an RGB or RGBA one (``(9797 R + 19234 G + 3737 B) >> 15``, alpha dropped),
and a baseline JPEG's Y component.  The readers take non-interlaced PNGs
with any of the five row filters (what cv2 and other encoders write); the
writers write 8-bit grayscale or RGB with no row filter.
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


_COLOR_TYPES = {0: 1, 4: 2, 2: 3, 6: 4}  # PNG colour type -> samples a pixel


def write_png(path, image: np.ndarray) -> None:
    """Write a [H, W] (grayscale) or [H, W, 3] (RGB, file order) uint8 image
    as an 8-bit PNG."""
    img = np.asarray(image)
    if (img.dtype != np.uint8 or img.ndim not in (2, 3) or 0 in img.shape
            or (img.ndim == 3 and img.shape[2] != 3)):
        raise ValueError(f"write_png takes a non-empty [H, W] or [H, W, 3] uint8 image, got "
                         f"{img.dtype} {img.shape}")
    h, w = img.shape[:2]
    rows = img.reshape(h, -1)
    raw = np.zeros((h, rows.shape[1] + 1), np.uint8)  # filter type 0 (None) before each row
    raw[:, 1:] = rows
    header = struct.pack(">IIBBBBB", w, h, 8, 0 if img.ndim == 2 else 2, 0, 0, 0)
    Path(path).write_bytes(PNG_SIGNATURE + _chunk(b"IHDR", header)
                           + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                           + _chunk(b"IEND", b""))


def write_png_gray(path, image: np.ndarray) -> None:
    """Write a [H, W] uint8 image as an 8-bit grayscale PNG."""
    img = np.asarray(image)
    if img.ndim != 2 or img.dtype != np.uint8 or 0 in img.shape:
        raise ValueError(f"write_png_gray takes a non-empty [H, W] uint8 image, got "
                         f"{img.dtype} {img.shape}")
    write_png(path, img)


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters of 8-bit scanlines of ``stride`` bytes, ``bpp``
    bytes a pixel (the left neighbour of a byte is ``bpp`` bytes before it)."""
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        kind, line = raw[y, 0], raw[y, 1:]
        if kind == 0:
            row = line.copy()
        elif kind == 1:  # Sub
            row = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:  # Up
            row = line + prev
        elif kind in (3, 4):  # Average, Paeth: each byte needs its left neighbour
            vals, ups = line.tolist(), prev.tolist()
            cur = [0] * stride
            for x in range(stride):
                left = cur[x - bpp] if x >= bpp else 0
                if kind == 3:
                    pred = (left + ups[x]) >> 1
                else:
                    pred = _paeth(left, ups[x], ups[x - bpp] if x >= bpp else 0)
                cur[x] = (vals[x] + pred) & 0xFF
            row = np.array(cur, np.uint8)
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {kind}")
        out[y] = row
        prev = row
    return out


def _read_png(path):
    """An 8-bit non-interlaced PNG as ([H, W, samples] uint8, colour type),
    or ValueError naming what it is."""
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
    if depth != 8 or color not in _COLOR_TYPES or interlace != 0:
        raise ValueError(
            f"{path}: vfp_tpu_torch reads 8-bit non-interlaced PNGs of colour type 0 "
            f"(8-bit grayscale), 2 (RGB), 4 (gray + alpha) or 6 (RGBA) only (this one: "
            f"bit depth {depth}, colour type {color}, interlace {interlace})")
    bpp = _COLOR_TYPES[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (w * bpp + 1):
        raise ValueError(f"{path}: image data holds {raw.size} bytes, not {h * (w * bpp + 1)}")
    return _unfilter(raw.reshape(h, w * bpp + 1), h, w * bpp, bpp).reshape(h, w, bpp), color


def read_png_gray(path) -> np.ndarray:
    """An 8-bit grayscale, non-interlaced PNG as a [H, W] uint8 array."""
    img, color = _read_png(path)
    if color != 0:
        raise ValueError(
            f"{path}: vfp_tpu_torch reads 8-bit grayscale PNGs only here (this one: colour "
            f"type {color}); convert it to 8-bit gray first")
    return img[..., 0]


def read_image_bgr(path) -> np.ndarray:
    """A picture as ``cv2.imread(path, cv2.IMREAD_COLOR)`` gives it: [H, W, 3]
    uint8 BGR.  PNG (8-bit gray replicated, gray + alpha and RGBA with the
    alpha dropped, RGB) or baseline JPEG (the port's decoder, which equals
    ``cv2.imdecode``), told apart by their signatures; anything else raises
    ``ValueError`` naming what is read."""
    with open(path, "rb") as f:
        head = f.read(8)
    if head == PNG_SIGNATURE:
        img, _ = _read_png(path)
        gray = img.shape[2] <= 2
        return np.ascontiguousarray(np.repeat(img[..., :1], 3, axis=2) if gray
                                    else img[..., 2::-1])
    if head[:2] == b"\xff\xd8":
        from ..native.jpeg import decode_jpeg

        return np.ascontiguousarray(decode_jpeg(Path(path).read_bytes())[..., ::-1])
    raise ValueError(f"{path}: vfp_tpu_torch reads PNG (8-bit gray, gray + alpha, RGB, "
                     "RGBA) and baseline JPEG images only")


# libpng's png_set_rgb_to_gray_fixed weights for cv2's (0.299, 0.587): red and
# green as int(w * 32768), blue the rest of 32768
_GRAY_R, _GRAY_G = 9797, 19234
_GRAY_B = 32768 - _GRAY_R - _GRAY_G


def read_image_gray(path) -> np.ndarray:
    """An image as ``cv2.imread(path, cv2.IMREAD_GRAYSCALE)`` gives it: [H, W]
    uint8.  PNG: gray (and gray + alpha, alpha dropped) as stored; RGB and
    RGBA through libpng's rgb-to-gray, ``(9797 R + 19234 G + 3737 B) >> 15``
    truncated, alpha dropped (cv2 reads PNGs with libpng, which converts
    there).  A baseline three-component JPEG: its Y component, as libjpeg's
    grayscale output gives it.  Anything else raises IOError naming it."""
    with open(path, "rb") as f:
        head = f.read(8)
    if head == PNG_SIGNATURE:
        try:
            img, color = _read_png(path)
        except ValueError as e:
            raise IOError(str(e)) from e
        if color in (0, 4):
            return np.ascontiguousarray(img[..., 0])
        rgb = img[..., :3].astype(np.uint32)
        gray = (_GRAY_R * rgb[..., 0] + _GRAY_G * rgb[..., 1] + _GRAY_B * rgb[..., 2]) >> 15
        return gray.astype(np.uint8)
    if head[:2] == b"\xff\xd8":
        from ..native.jpeg import decode_jpeg_gray

        return decode_jpeg_gray(Path(path).read_bytes())
    raise IOError(f"{path}: vfp_tpu_torch reads --wm-image as PNG (8-bit gray, gray + "
                  "alpha, RGB, RGBA) or a baseline three-component JPEG only")
