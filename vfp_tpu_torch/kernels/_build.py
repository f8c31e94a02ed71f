"""Build ``csrc/*.cu`` with nvcc into one shared library and bind it with ctypes.

The library has a plain C interface (no PyTorch headers), so nvcc takes
seconds.  It is built at the first kernel launch, never at import, into
``build/vfp_tpu_torch/<hash>/`` at the repository root, keyed by a hash of
the sources and the flags; later launches in the process, and later
processes with the same sources, load the file that is there.

Flags: ``sm_90a`` (Hopper), ``-O3``, and ``--fmad=false`` with no fast-math
flag, so division and square root are IEEE and no multiply-add is
contracted: the kernels then round as their plain PyTorch versions do.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "vfp_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "--fmad=false",
)
LIB_NAME = "libvfp_tpu_torch_kernels.so"

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argtypes of every exported launcher: every pointer and the stream as c_void_p
SIGNATURES = {
    "vfp_qim_triplet_soa": [_P, _P, _I, _I, _P, _P],
    "vfp_qim_decode_soa": [_P, _P, _I, _I, _F, _P, _P],
    "vfp_qim_embed_soa": [_P, _P, _P, _I, _I, _F, _P, _P],
    "vfp_fused_mark_planar": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P, _P, _P],
    "vfp_fused_extract_planar": [_P, _P, _P, _I, _I, _I, _F, _P, _P, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None  # wall time of the nvcc run, None if loaded from disk


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found is None and CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        found = str(cand) if cand.exists() else None
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit "
                           "(nvcc on PATH or under CUDA_HOME)")
    return found


def build_command(out: Path) -> list[str]:
    return [nvcc(), *NVCC_FLAGS, "-o", str(out), *(str(p) for p in sorted(CSRC.glob("*.cu")))]


def _compile(path: Path) -> None:
    global build_seconds
    path.parent.mkdir(parents=True, exist_ok=True)
    # build beside the target and rename, so a concurrent process never loads
    # a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=path.parent)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        r = subprocess.run(build_command(Path(tmp)), capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"nvcc failed (exit {r.returncode}):\n{r.stderr}{r.stdout}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    build_seconds = time.perf_counter() - t0


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this source hash has none."""
    global _lib
    with _lock:
        if _lib is None:
            path = BUILD_ROOT / source_hash() / LIB_NAME
            if not path.exists():
                _compile(path)
            lib = ctypes.CDLL(str(path))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.vfp_error_string.argtypes = [ctypes.c_int]
            lib.vfp_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def launch(name: str, *args) -> None:
    """Call launcher ``name`` on the current CUDA stream; raise on a launch error."""
    lib = library()
    err = getattr(lib, name)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}: {lib.vfp_error_string(err).decode()}")
