"""Compile and load the vfpio streaming library (ctypes).

Built with g++ at first use, never at import, into
``build/vfp_tpu_torch/native/<hash>/`` at the repository root, keyed by a
hash of the source and the flags; later processes load the file that is
there.  Host file I/O only: no device code.
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

SRC = Path(__file__).resolve().parent / "vfpio.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "vfp_tpu_torch" / "native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
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
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def library_path() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode() + SRC.read_bytes())
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
        r = subprocess.run(["g++", *GXX_FLAGS, str(SRC), "-o", tmp], capture_output=True,
                           text=True)
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
