"""The DT-CWT embed delta's whole synthesis in one launch (CUDA:
``csrc/dtcwt_delta.cu``).

Replaces the Pallas kernel ``dtcwt_delta_synthesis`` of
``vfp_tpu/kernels/dtcwt_delta.py``: level-3 highpass delta planes
[B, 12, h3, w3] ([lh*4, hl*4, hh*4], combos (rt, ct) row-major, a zero
lowpass at every level) -> the pixel delta [B, 8 h3, 8 w3].  Per tree: a
full q-shift synthesis at level 3, a lowpass-only q-shift synthesis at level
2, a lowpass-only LeGall synthesis at level 1; then the 4-tree average.  The
rolls (``QSHIFT_ROLL_*`` = -13, ``LEGALL_ROLL`` = -3) fold into the index:
with y2 the zero-upsampled input (y2[2j + p] = y[j]) every stage computes

    out[i] = sum_k f[k] * y2[(i - roll - k) mod 2n]      (k from 0 upward,
                                                          the zero taps skipped)

columns first, then rows, as ``ops/dtcwt.py:Transform2d`` does.  The level
geometry is exact (2 h3 and 4 h3 rows at levels 2 and 1, no crops), as where
the JAX codec takes its fused kernel.

The plain version (``dtcwt_delta_synthesis_reference``) is that three-stage
chain of the plain ``Transform2d`` (``ops/dtcwt.py``).  It folds over every
tap of the zero-upsampled input, the zeros included, and the kernel skips
the zero terms; adding a zero leaves a float sum unchanged, so both round
alike.
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
    """g0a, g1a, g0b, g1b (14 each), LeGall g0 (3), then the rolls as floats
    (q-shift a, q-shift b, LeGall), in the order of ``DeltaParams``."""
    return np.ascontiguousarray(np.concatenate(
        [C.QSHIFT_G0A, C.QSHIFT_G1A, C.QSHIFT_G0B, C.QSHIFT_G1B, C.LEGALL_G0,
         [C.QSHIFT_ROLL_A, C.QSHIFT_ROLL_B, C.LEGALL_ROLL]]).astype(np.float32))


def dtcwt_delta_synthesis_reference(dsubs: torch.Tensor) -> torch.Tensor:
    t = Transform2d("torch")
    d3 = torch.cat([dsubs.new_zeros((dsubs.shape[0], 4, *dsubs.shape[2:])), dsubs], dim=1)
    return t.synthesis_legall_ll(t.synthesis_qshift_ll(t.synthesis_qshift(d3)))


def dtcwt_delta_synthesis(dsubs: torch.Tensor) -> torch.Tensor:
    """f32 [B, 12, h3, w3] level-3 delta planes -> [B, 8 h3, 8 w3] pixel delta."""
    if dsubs.dtype != torch.float32 or dsubs.dim() != 4 or dsubs.shape[1] != 12:
        raise ValueError(f"dtcwt_delta_synthesis: want float32 [B, 12, h3, w3], got "
                         f"{dsubs.dtype} {tuple(dsubs.shape)}")
    if not dsubs.is_cuda:
        return dtcwt_delta_synthesis_reference(dsubs)
    dsubs = dsubs.contiguous()
    b, _, h3, w3 = dsubs.shape
    out = torch.empty((b, 8 * h3, 8 * w3), dtype=torch.float32, device=dsubs.device)
    _build.launch("vfp_dtcwt_delta_synthesis", dsubs.device, dsubs.data_ptr(), out.data_ptr(),
                  b, h3, w3, _params_host().ctypes.data)
    dtcwt_delta_synthesis.launches += 1
    return out


dtcwt_delta_synthesis.launches = 0
