"""Baseline JPEG of RGB frames (and the encoder of gray images) over the
native library's ``jpeg.cpp``.

The port's counterpart of ``cv2.imencode('.jpg', bgr, [IMWRITE_JPEG_QUALITY,
q])`` and ``cv2.imdecode(..., IMREAD_COLOR)``: the same bytes and the same
pixels as libjpeg-turbo under OpenCV's defaults (4:2:0, islow DCT, fancy
upsampling), on frames in file byte order (RGB).  A batch runs one frame per
task on a thread pool (ctypes releases the GIL), results in order.  The
library is built with g++ at first use; where it cannot be built, the
compiler's message is raised: there is no pure-Python JPEG.
"""

from __future__ import annotations

import ctypes
import os
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .build import load_vfpio

_ERR_LEN = 256
_pool: ThreadPoolExecutor | None = None
_pool_lock = threading.Lock()


def pool_size() -> int:
    """The host CPUs this process may run on."""
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:
        return os.cpu_count() or 1


def _map(fn, items):
    """fn over items on the shared pool, in order; one item runs inline."""
    global _pool
    if len(items) <= 1:
        return [fn(x) for x in items]
    with _pool_lock:
        if _pool is None:
            _pool = ThreadPoolExecutor(max_workers=pool_size(), thread_name_prefix="vfp-jpeg")
    return list(_pool.map(fn, items))


def encode_jpeg(frame: np.ndarray, quality: int = 95) -> bytes:
    """One [H, W, 3] uint8 RGB frame -> a baseline 4:2:0 JPEG at ``quality``."""
    lib = load_vfpio()
    f = np.ascontiguousarray(frame, dtype=np.uint8)
    if f.ndim != 3 or f.shape[2] != 3:
        raise ValueError(f"want an [H, W, 3] frame, got {f.shape}")
    h, w = f.shape[:2]
    cap = lib.vfpjpeg_encode_bound(w, h)
    if cap < 0:
        raise ValueError(f"JPEG cannot hold a {w}x{h} frame")
    buf = np.empty(cap, np.uint8)  # the worst case; only the pages written are touched
    n = lib.vfpjpeg_encode(f.ctypes.data, w, h, int(quality), buf.ctypes.data, cap)
    if n < 0:
        raise IOError(f"JPEG encode of a {w}x{h} frame failed")
    return buf[:n].tobytes()


def encode_jpeg_gray(image: np.ndarray, quality: int = 95) -> bytes:
    """One [H, W] uint8 image -> a baseline one-component (grayscale) JPEG at
    ``quality``: the bytes of ``cv2.imencode('.jpg', image)``."""
    lib = load_vfpio()
    g = np.ascontiguousarray(image, dtype=np.uint8)
    if g.ndim != 2:
        raise ValueError(f"want an [H, W] image, got {g.shape}")
    h, w = g.shape
    cap = lib.vfpjpeg_encode_bound(w, h)
    if cap < 0:
        raise ValueError(f"JPEG cannot hold a {w}x{h} image")
    buf = np.empty(cap, np.uint8)
    n = lib.vfpjpeg_encode_gray(g.ctypes.data, w, h, int(quality), buf.ctypes.data, cap)
    if n < 0:
        raise IOError(f"JPEG encode of a {w}x{h} image failed")
    return buf[:n].tobytes()


def jpeg_size(data: bytes) -> tuple[int, int]:
    """(width, height) from a JPEG's frame header."""
    lib = load_vfpio()
    w, h = ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(_ERR_LEN)
    if lib.vfpjpeg_decode_header(data, len(data), ctypes.byref(w), ctypes.byref(h), err,
                                 _ERR_LEN):
        raise IOError(err.value.decode(errors="replace"))
    return w.value, h.value


def decode_jpeg_into(data: bytes, out: np.ndarray) -> np.ndarray:
    """Decode a JPEG into ``out``, a C-contiguous [H, W, 3] uint8 array of its size."""
    lib = load_vfpio()
    h, w = out.shape[:2]
    if out.dtype != np.uint8 or out.shape != (h, w, 3) or not out.flags.c_contiguous:
        raise ValueError("want a C-contiguous [H, W, 3] uint8 output")
    err = ctypes.create_string_buffer(_ERR_LEN)
    if lib.vfpjpeg_decode(data, len(data), out.ctypes.data, w, h, err, _ERR_LEN):
        raise IOError(err.value.decode(errors="replace"))
    return out


def decode_jpeg(data: bytes) -> np.ndarray:
    """A JPEG -> its [H, W, 3] uint8 RGB frame, as ``cv2.imdecode`` gives it (in RGB)."""
    w, h = jpeg_size(data)
    return decode_jpeg_into(data, np.empty((h, w, 3), np.uint8))


def decode_jpeg_gray(data: bytes) -> np.ndarray:
    """A three-component JPEG -> its [H, W] uint8 Y component, as
    ``cv2.imdecode(..., IMREAD_GRAYSCALE)`` gives it (libjpeg's grayscale
    output copies Y and converts no colour)."""
    lib = load_vfpio()
    w, h = jpeg_size(data)
    out = np.empty((h, w), np.uint8)
    err = ctypes.create_string_buffer(_ERR_LEN)
    if lib.vfpjpeg_decode_gray(data, len(data), out.ctypes.data, w, h, err, _ERR_LEN):
        raise IOError(err.value.decode(errors="replace"))
    return out


def encode_jpegs(frames: np.ndarray, quality: int = 95) -> list[bytes]:
    """Each frame of a [B, H, W, 3] batch -> its JPEG, in order."""
    return _map(lambda f: encode_jpeg(f, quality), list(frames))


def decode_jpegs(chunks, height: int, width: int) -> np.ndarray:
    """JPEGs of one size -> one [B, H, W, 3] uint8 batch, in order."""
    out = np.empty((len(chunks), height, width, 3), np.uint8)
    _map(lambda i: decode_jpeg_into(chunks[i], out[i]), range(len(chunks)))
    return out
