"""Build ``csrc/*.cu`` with nvcc into one shared library and bind it with ctypes.

The library has a plain C interface (no PyTorch headers), so nvcc takes
seconds.  It is built at the first kernel launch, never at import, into
``build/vfp_tpu_torch/<hash>/`` at the repository root, keyed by a hash of
the sources and the flags; later launches in the process, and later
processes with the same sources, load the file that is there.  Each ``.cu``
compiles in its own nvcc process, all started together, and one more links
the objects.

Flags: ``sm_90a`` (Hopper), ``-O3``, and ``--fmad=false`` with no fast-math
flag, so division and square root are IEEE and no multiply-add is
contracted: the kernels then round as their plain PyTorch versions do.
``-Xptxas=-v`` reports each kernel's registers and spills into ``build_log``.
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "--fmad=false", "-Xptxas=-v",
)
LIB_NAME = "libvfp_tpu_torch_kernels.so"

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# argtypes of every exported launcher: every pointer and the stream as c_void_p
SIGNATURES = {
    "vfp_qim_triplet_soa": [_P, _P, _I, _I, _P, _P],
    "vfp_qim_decode_soa": [_P, _P, _I, _I, _F, _P, _P],
    "vfp_qim_embed_soa": [_P, _P, _P, _I, _I, _F, _P, _P],
    "vfp_fused_mark_planar": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P, _P, _P],
    "vfp_fused_extract_planar": [_P, _P, _P, _I, _I, _I, _F, _P, _P, _P],
    "vfp_fused_mark_planar_int": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P, _P, _P],
    "vfp_fused_extract_planar_int": [_P, _P, _P, _I, _I, _I, _F, _P, _P, _P],
    "vfp_y_dc_mean": [_P, _P, _P, _P, _I, _I, _I, _P, _P],
    "vfp_fused_dct_qim_mark": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P, _P],
    "vfp_fused_dct_qim_extract": [_P, _P, _P, _P, _I, _I, _I, _P, _P],
    "vfp_dct_qim_decide": [_P, _P, _I, _P, _I, _I, _F, _P],
    "vfp_dtcwt_level1_ll_y": [_P, _P, _I, _I, _I, _P, _P],
    "vfp_dtcwt_level1_analysis": [_P, _P, _I, _I, _I, _P, _P],
    "vfp_dtcwt_level1_ll_color": [_P, _P, _I, _I, _I, _P, _P],
    "vfp_dtcwt_qshift_masks": [_P, _P, _I, _I, _I, _I, _F, _P, _P],
    "vfp_dtcwt_delta_synthesis": [_P, _P, _I, _I, _I, _P, _P],
    "vfp_dtcwt_qshift_ll": [_P, _P, _I, _I, _I, _I, _P, _P],
    "vfp_dtcwt_qshift_hp": [_P, _P, _I, _I, _I, _I, _P, _P],
    "vfp_dtcwt_legall_synthesis_hp": [_P, _P, _I, _I, _I, _P, _P],
    "vfp_dtcwt_level1_analysis_ll": [_P, _P, _I, _I, _I, _L, _L, _L, _P, _P],
    "vfp_dtcwt_qshift_analysis": [_P, _P, _I, _I, _I, _I, _P, _P],
    "vfp_dtcwt_qshift_synthesis": [_P, _P, _I, _I, _I, _P, _P],
    "vfp_dtcwt_qshift_synthesis_ll": [_P, _P, _I, _I, _I, _P, _P],
    "vfp_dtcwt_legall_synthesis": [_P, _P, _I, _I, _I, _P, _P],
    "vfp_dtcwt_legall_synthesis_ll": [_P, _P, _I, _I, _I, _P, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_fns: dict = {}  # launcher name -> its ctypes function, resolved once when the library loads
build_seconds: float | None = None  # wall time of the nvcc runs, None if loaded from disk
build_log = ""  # nvcc's and ptxas's reports of the last build in this process


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


def compile_command(src: Path, obj: Path) -> list[str]:
    return [nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]


def link_command(objs: list[Path], out: Path) -> list[str]:
    return [nvcc(), "-shared", "-o", str(out), *(str(o) for o in objs)]


def _run_all(commands: list[list[str]]) -> str:
    """Run the commands in parallel; raise on the first that fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in commands]
    outs = [p.communicate()[0] for p in procs]
    for c, p, out in zip(commands, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed (exit {p.returncode}): {' '.join(c)}\n{out}")
    return "".join(outs)


def _compile(path: Path) -> None:
    global build_seconds, build_log
    path.parent.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    # build beside the target and rename, so a concurrent process never loads
    # a half-written library
    with tempfile.TemporaryDirectory(dir=path.parent) as tmp:
        srcs = sorted(CSRC.glob("*.cu"))
        objs = [Path(tmp) / (s.stem + ".o") for s in srcs]
        log = _run_all([compile_command(s, o) for s, o in zip(srcs, objs)])
        lib = Path(tmp) / LIB_NAME
        log += _run_all([link_command(objs, lib)])
        os.replace(lib, path)
    build_seconds = time.perf_counter() - t0
    build_log = log


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this source hash has none."""
    global _lib
    if _lib is not None:  # loaded: no lock
        return _lib
    with _lock:
        if _lib is None:
            path = BUILD_ROOT / source_hash() / LIB_NAME
            if not path.exists():
                _compile(path)
            lib = ctypes.CDLL(str(path))
            fns = {}
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                fns[name] = fn
            lib.vfp_error_string.argtypes = [ctypes.c_int]
            lib.vfp_error_string.restype = ctypes.c_char_p
            _lib = lib  # before the launchers: a thread that finds one finds the library
            _fns.update(fns)
        return _lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call launcher ``name`` on the current stream of CUDA ``device``;
    raise on a launch error.  The per-call host path is short: each
    launcher is resolved once, the loaded library takes no lock, and the
    device context is entered only when ``device`` is not the current
    one."""
    fn = _fns.get(name)
    if fn is None:
        library()
        fn = _fns[name]
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    if index == current:
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}: {_lib.vfp_error_string(err).decode()}")
