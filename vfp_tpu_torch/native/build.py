"""Compile and load the port's native host library (ctypes).

One shared library from two sources: ``vfpio.cpp`` (``.rawv`` streaming) and
``jpeg.cpp`` (the baseline JPEG codec of the MJPEG-AVI files).  Built with
g++ at first use, never at import, into ``build/vfp_tpu_torch/native/<hash>/``
at the repository root, keyed by a hash of both sources and the flags; later
processes load the file that is there.  Host code only: no device code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

SOURCES = tuple(Path(__file__).resolve().parent / name for name in ("vfpio.cpp", "jpeg.cpp"))
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "vfp_tpu_torch" / "native"
# -fwrapv: the JPEG decoder's integer IDCT wraps on corrupt coefficients, as
# libjpeg's does, instead of meeting undefined behaviour
GXX_FLAGS = ("-O3", "-fwrapv", "-shared", "-fPIC", "-std=c++17", "-pthread")
LIB_NAME = "libvfpio.so"

_P, _L, _I = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
# (restype, argtypes) of every exported function
SIGNATURES = {
    "vfpio_reader_open_file": (_P, [ctypes.c_char_p, _L, _I, _L]),
    "vfpio_read_batch": (_L, [_P, ctypes.c_char_p, _L]),
    "vfpio_reader_close": (None, [_P]),
    "vfpio_writer_open_file": (_P, [ctypes.c_char_p, _L, _I]),
    "vfpio_write_batch": (_L, [_P, ctypes.c_char_p, _L]),
    "vfpio_writer_close": (_I, [_P]),
    "vfpjpeg_encode_bound": (_L, [_I, _I]),
    "vfpjpeg_encode": (_L, [_P, _I, _I, _I, _P, _L]),
    "vfpjpeg_encode_gray": (_L, [_P, _I, _I, _I, _P, _L]),
    "vfpjpeg_decode_header": (_I, [ctypes.c_char_p, _L, ctypes.POINTER(_I), ctypes.POINTER(_I),
                                   ctypes.c_char_p, _I]),
    "vfpjpeg_decode": (_I, [ctypes.c_char_p, _L, _P, _I, _I, ctypes.c_char_p, _I]),
    "vfpjpeg_decode_gray": (_I, [ctypes.c_char_p, _L, _P, _I, _I, ctypes.c_char_p, _I]),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for src in SOURCES:
        h.update(src.name.encode() + src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / LIB_NAME


def have_native() -> bool:
    """Whether the library can be loaded: g++ is there to build it, or it is built."""
    return shutil.which("g++") is not None or library_path().exists()


def _compile(path: Path) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    # build beside the target and rename, so a concurrent process never loads
    # a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=path.parent)
    os.close(fd)
    try:
        r = subprocess.run(["g++", *GXX_FLAGS, *map(str, SOURCES), "-o", tmp],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"g++ failed (exit {r.returncode}):\n{r.stderr}{r.stdout}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_vfpio() -> ctypes.CDLL:
    """The loaded library, built first if this source hash has none."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                _compile(path)
            lib = ctypes.CDLL(str(path))
            for name, (restype, argtypes) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            _lib = lib
        return _lib
