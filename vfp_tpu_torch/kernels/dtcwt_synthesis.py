"""The DT-CWT decode's level-1 synthesis on the card (CUDA:
``csrc/dtcwt_synthesis.cu``).

``dtcwt_legall_synthesis_hp`` replaces the Pallas kernel of the same name in
``vfp_tpu/kernels/dtcwt_synthesis.py``: the 12 level-1 highpass planes
[B, 12, h, w] ([lh*4, hl*4, hh*4], tree combos (rt, ct) row-major) with a
zero lowpass -> the reconstruction [B, 2h, 2w], before any crop.  Per tree,
with the LeGall synthesis pair and y2 the zero-upsampled input (y2[2a + p] =
y[a]), every stage computes

    up2(y, f, p)[n] = sum_k f[k] * y2[(n - k) mod 2N]      (k from 0 upward,
                                                            the zero taps skipped)

columns first (lo = up2(lh, g1, ct), hi = up2(hl, g0, ct) + up2(hh, g1, ct)),
then rows (up2(lo, g0, rt) + up2(hi, g1, rt)); then a roll by
``LEGALL_ROLL`` on both axes, the sum over the 4 trees in order and x 0.25,
as ``ops/dtcwt.py:Transform2d.synthesis_legall_hp`` does.  The other five
synthesis kernels of that file are not ported yet (ROADMAP.md queue 1).

The plain version (``dtcwt_legall_synthesis_hp_reference``) is that block of
the plain transform.  It folds over every tap of the zero-upsampled input,
the zeros included, and the kernel skips the zero terms; adding a zero leaves
a float sum unchanged, so both round alike (``--fmad=false``).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..ops import dtcwt_coeffs as C
from ..ops.dtcwt import Transform2d
from . import _build


@lru_cache(maxsize=None)
def _params_host() -> np.ndarray:
    """LeGall g0 (3), g1 (5), then the roll as a float, in the order of
    ``SynParams``."""
    return np.ascontiguousarray(np.concatenate(
        [C.LEGALL_G0, C.LEGALL_G1, [C.LEGALL_ROLL]]).astype(np.float32))


def dtcwt_legall_synthesis_hp_reference(subs12: torch.Tensor) -> torch.Tensor:
    return Transform2d("torch").synthesis_legall_hp(subs12)


def dtcwt_legall_synthesis_hp(subs12: torch.Tensor) -> torch.Tensor:
    """f32 [B, 12, h, w] level-1 highpass planes -> [B, 2h, 2w]."""
    if subs12.dtype != torch.float32 or subs12.dim() != 4 or subs12.shape[1] != 12:
        raise ValueError(f"dtcwt_legall_synthesis_hp: want float32 [B, 12, h, w], got "
                         f"{subs12.dtype} {tuple(subs12.shape)}")
    if not subs12.is_cuda:
        return dtcwt_legall_synthesis_hp_reference(subs12)
    subs12 = subs12.contiguous()
    b, _, h, w = subs12.shape
    out = torch.empty((b, 2 * h, 2 * w), dtype=torch.float32, device=subs12.device)
    with torch.cuda.device(subs12.device):
        _build.launch("vfp_dtcwt_legall_synthesis_hp", subs12.data_ptr(), out.data_ptr(), b, h,
                      w, _params_host().ctypes.data)
    dtcwt_legall_synthesis_hp.launches += 1
    return out


dtcwt_legall_synthesis_hp.launches = 0
