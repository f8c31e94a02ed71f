"""DT-CWT level-1 analysis on the card (CUDA: ``csrc/dtcwt_level1.cu``).

``dtcwt_level1_ll_y`` replaces the Pallas kernels
``dtcwt_level1_analysis_ll_y`` and ``dtcwt_level1_ll_y_chain`` of
``vfp_tpu/kernels/dtcwt_level1.py``: u8 frames [B, H, W, 3] -> the Y
channel's 4 tree lowpasses [B, 4, H/2, W/2] (the mark path's mask input).
``dtcwt_level1_analysis`` replaces ``dtcwt_level1_analysis`` of the same
file: f32 [B, H, W] -> the 16 level-1 planes [ll*4, lh*4, hl*4, hh*4], tree
combos (rt, ct) row-major (the watermark plane's spectrum).

Both compute, per tree (rt, ct): a row pass down2(x, f, rt) along H, then a
column pass down2(., g, ct) along W, with the LeGall pair and circular
indexing, y[m] = sum_k f[k] * x[(2m + phase - k) mod N] (``ops/dtcwt.py``).
The chained and unchained Pallas twins differ only in their pad layout; one
kernel with modular indexing covers both and copies nothing.

The plain versions (``*_reference``) are the plain transform's level-1
analysis (``ops/dtcwt.py``), which folds every sum in the kernels' order:
Y = ((M_FWD[0,0] b + M_FWD[0,1] g) + M_FWD[0,2] r) + OFF_FWD[0], then each
filter sum from k = 0 upward.  The kernels build with ``--fmad=false``, so
both sides round alike.  Each wrapper takes its plain version for a CPU
tensor and launches the kernel for a CUDA tensor; ``.launches`` counts.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..ops import dtcwt_coeffs as C
from ..ops.color import M_FWD, OFF_FWD
from ..ops.dtcwt import Transform2d
from . import _build
from .fused_dct_qim import _lincomb


@lru_cache(maxsize=None)
def _params_host() -> np.ndarray:
    """The kernels' constants in the order of ``L1Params`` in the .cu: LeGall
    h0 (5), h1 (3), M_FWD[0] (3), OFF_FWD[0]."""
    return np.ascontiguousarray(np.concatenate(
        [C.LEGALL_H0, C.LEGALL_H1, M_FWD[0], OFF_FWD[:1]]).astype(np.float32))


def _check(x: torch.Tensor, name: str, dtype, ndim: int) -> None:
    if x.dtype != dtype or x.dim() != ndim or (ndim == 4 and x.shape[-1] != 3):
        want = "uint8 [B, H, W, 3]" if ndim == 4 else "float32 [B, H, W]"
        raise ValueError(f"{name}: want {want}, got {x.dtype} {tuple(x.shape)}")
    if x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f"{name} requires even H and W, got {tuple(x.shape[1:3])}")


# -- dtcwt_level1_ll_y -------------------------------------------------------------

def dtcwt_level1_ll_y_reference(frames: torch.Tensor) -> torch.Tensor:
    y = _lincomb(frames.permute(0, 3, 1, 2), 0)
    return Transform2d("torch").analysis_level1(y, lowpass_only=True)[0]


def dtcwt_level1_ll_y(frames: torch.Tensor) -> torch.Tensor:
    """u8 frames [B, H, W, 3] (H, W even) -> f32 [B, 4, H/2, W/2]: the Y
    channel's 4 level-1 tree lowpasses, combos (rt, ct) row-major."""
    _check(frames, "dtcwt_level1_ll_y", torch.uint8, 4)
    if not frames.is_cuda:
        return dtcwt_level1_ll_y_reference(frames)
    frames = frames.contiguous()
    b, h, w, _ = frames.shape
    out = torch.empty((b, 4, h // 2, w // 2), dtype=torch.float32, device=frames.device)
    with torch.cuda.device(frames.device):
        _build.launch("vfp_dtcwt_level1_ll_y", frames.data_ptr(), out.data_ptr(), b, h, w,
                      _params_host().ctypes.data)
    dtcwt_level1_ll_y.launches += 1
    return out


dtcwt_level1_ll_y.launches = 0


# -- dtcwt_level1_analysis ---------------------------------------------------------

def dtcwt_level1_analysis_reference(x: torch.Tensor) -> torch.Tensor:
    return Transform2d("torch").analysis_level1(x)[0]


def dtcwt_level1_analysis(x: torch.Tensor) -> torch.Tensor:
    """f32 [B, H, W] (H, W even) -> [B, 16, H/2, W/2]: planes [ll*4, lh*4,
    hl*4, hh*4], tree combos (rt, ct) row-major within each band."""
    _check(x, "dtcwt_level1_analysis", torch.float32, 3)
    if not x.is_cuda:
        return dtcwt_level1_analysis_reference(x)
    x = x.contiguous()
    b, h, w = x.shape
    out = torch.empty((b, 16, h // 2, w // 2), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        _build.launch("vfp_dtcwt_level1_analysis", x.data_ptr(), out.data_ptr(), b, h, w,
                      _params_host().ctypes.data)
    dtcwt_level1_analysis.launches += 1
    return out


dtcwt_level1_analysis.launches = 0
