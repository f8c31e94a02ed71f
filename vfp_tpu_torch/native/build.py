"""Compile and load the port's native host libraries (ctypes).

Two shared libraries, each built with g++ at first use, never at import,
into ``build/vfp_tpu_torch/native/<hash>/`` at the repository root, keyed by
a hash of its sources and flags; later processes load the file that is
there.  Host code only: no device code.

- ``libvfpio.so`` from ``vfpio.cpp`` (frame streaming: ``.rawv`` files and
  command pipes) and ``jpeg.cpp``
  (the baseline JPEG codec of the MJPEG-AVI files);
- ``liblowlink.so`` from ``lowlink.cpp`` (the host half of the LL-domain
  transport, ``pipeline/lowlink.py``), with flags of its own:
  ``-ffp-contract=off`` (no FMA contraction, so each float expression keeps
  its source order) and, on x86, ``-mf16c -mavx2`` for ``_Float16``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

_HERE = Path(__file__).resolve().parent
SOURCES = tuple(_HERE / name for name in ("vfpio.cpp", "jpeg.cpp"))
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "vfp_tpu_torch" / "native"
# -fwrapv: the JPEG decoder's integer IDCT wraps on corrupt coefficients, as
# libjpeg's does, instead of meeting undefined behaviour
GXX_FLAGS = ("-O3", "-fwrapv", "-shared", "-fPIC", "-std=c++17", "-pthread")
LIB_NAME = "libvfpio.so"

LOWLINK_SOURCES = (_HERE / "lowlink.cpp",)
# _Float16 needs F16C on x86; other machines (aarch64) have it natively
_X86_F16 = (("-mf16c", "-mavx2") if platform.machine() in ("x86_64", "AMD64", "i686")
            else ())
LOWLINK_FLAGS = ("-O3", *_X86_F16, "-ffp-contract=off", "-shared", "-fPIC", "-std=c++17")
LOWLINK_LIB_NAME = "liblowlink.so"

_P, _L, _I = ctypes.c_void_p, ctypes.c_long, ctypes.c_int
# (restype, argtypes) of every exported function
SIGNATURES = {
    "vfpio_reader_open_file": (_P, [ctypes.c_char_p, _L, _I, _L]),
    "vfpio_reader_open_cmd": (_P, [ctypes.c_char_p, _L, _I]),
    "vfpio_read_batch": (_L, [_P, ctypes.c_char_p, _L]),
    "vfpio_reader_close": (_I, [_P]),
    "vfpio_writer_open_file": (_P, [ctypes.c_char_p, _L, _I]),
    "vfpio_writer_open_cmd": (_P, [ctypes.c_char_p, _L, _I]),
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
_F = ctypes.c_float
LOWLINK_SIGNATURES = {
    "vfpio_reconstruct": (None, [_P, _P, _P, _P, _P, _P, _L, _L, _L, _L, _L]),
    "vfpio_host_ll": (None, [_P, _P, _L, _L, _L, _L, _L, _F, _F, _F, _F]),
    "vfpio_qim_dll": (None, [_P, _P, _P, _L, _L, _L, _L, _F]),
    "vfpio_qim_repair": (None, [_P, _P, _P, _P, _L, _L, _L, _L, _F]),
    "vfpio_qim_bits": (None, [_P, _P, _L, _L, _L, _F]),
    "vfpio_recentre2": (None, [_P, _P, _P, _P, _P, _L, _L, _L, _L, _L, _F, _F, _F]),
}

_lock = threading.Lock()
_libs: dict = {}  # library file name -> loaded CDLL


def library_path(sources=SOURCES, flags=GXX_FLAGS, name=LIB_NAME) -> Path:
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        h.update(src.name.encode() + src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / name


def have_native() -> bool:
    """Whether the library can be loaded: g++ is there to build it, or it is built."""
    return shutil.which("g++") is not None or library_path().exists()


def _compile(path: Path, sources, flags) -> None:
    path.parent.mkdir(parents=True, exist_ok=True)
    # build beside the target and rename, so a concurrent process never loads
    # a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=path.parent)
    os.close(fd)
    try:
        r = subprocess.run(["g++", *flags, *map(str, sources), "-o", tmp],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"g++ failed (exit {r.returncode}):\n{r.stderr}{r.stdout}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load(sources, flags, name, signatures) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(sources, flags, name)
            if not path.exists():
                _compile(path, sources, flags)
            lib = ctypes.CDLL(str(path))
            for fn_name, (restype, argtypes) in signatures.items():
                fn = getattr(lib, fn_name)
                fn.restype, fn.argtypes = restype, argtypes
            _libs[name] = lib
        return lib


def load_vfpio() -> ctypes.CDLL:
    """The loaded streaming and JPEG library, built first if this source hash has none."""
    return _load(SOURCES, GXX_FLAGS, LIB_NAME, SIGNATURES)


def load_lowlink() -> ctypes.CDLL:
    """The loaded low-link host library, built first if this source hash has
    none.  A failed build raises: the transport has no other host path."""
    return _load(LOWLINK_SOURCES, LOWLINK_FLAGS, LOWLINK_LIB_NAME, LOWLINK_SIGNATURES)
