"""The DT-CWT codecs' perceptual masks in one launch (CUDA:
``csrc/dtcwt_masks.cu``).

Replaces the Pallas kernels ``dtcwt_qshift_masks`` and
``dtcwt_qshift_masks_chain`` of ``vfp_tpu/kernels/dtcwt_masks.py``: the Y
tree lowpasses [B, 4, h1, w1] -> the level-2 q-shift highpass analysis
(14-tap filters, trees a/b) -> the 6 subband magnitudes -> cv2's 2x2 mean
filter (reflect-101 at the top row and left column: row -1 reads row 1) ->
the 2x2 mean rebin onto the level-3 grid -> ceil(m / step), [B, 6, h1/4,
w1/4].  h1 and w1 must be multiples of 4 (the level-2 grid even, so the
rebin needs no zero row).  The codecs' ==0 guard and mask normalisation stay
outside, on the small output.  The input may be a view whose batch items
are each contiguous, such as ``ll[:, 0]`` of the detect path's
[B, 2, 4, h1, w1] level-1 output: the kernel takes the batch stride and
reads it in place (``batch_strided``).

``ceil`` turns a last-bit difference into a whole mask step, so the plain
version (``dtcwt_qshift_masks_reference``: the plain transform's level-2
highpasses, ``q2c_magnitudes``, ``filter2d_mean2x2``, the rebin) folds every
sum in the kernel's order: each filter sum from k = 0 upward,
|z| = 0.5 * sqrt(d * d + e * e),
the mean filter as 0.25 * (((x[i-1, j-1] + x[i-1, j]) + x[i, j-1]) + x[i, j])
(``ops/filters.py``), the rebin as 0.25 * (((m00 + m01) + m10) + m11), and an
IEEE division by the step (never a reciprocal multiply).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..ops import dtcwt_coeffs as C
from ..ops.dtcwt import Transform2d, q2c_magnitudes
from ..ops.filters import filter2d_mean2x2
from . import _build


@lru_cache(maxsize=None)
def _params_host() -> np.ndarray:
    """q-shift analysis filters h0a, h1a, h0b, h1b (14 each), as ``MaskParams``."""
    return np.ascontiguousarray(np.concatenate(
        [C.QSHIFT_H0A, C.QSHIFT_H1A, C.QSHIFT_H0B, C.QSHIFT_H1B]).astype(np.float32))


def batch_strided(x: torch.Tensor) -> tuple[torch.Tensor, int]:
    """``x`` [B, C, h, w] and its batch stride in elements, for a kernel that
    takes one: a view whose batch items are each contiguous (``ll[:, 0]`` of
    a contiguous [B, 2, C, h, w]) is used in place, any other layout copied."""
    _, c, h, w = x.shape
    if x.stride()[1:] != (h * w, w, 1):
        x = x.contiguous()
    if x.stride(0) >= 2 ** 31:
        raise ValueError(f"batch stride {x.stride(0)} does not fit the kernels' int")
    return x, x.stride(0)


def _check(ll4: torch.Tensor) -> None:
    if ll4.dtype != torch.float32 or ll4.dim() != 4 or ll4.shape[1] != 4:
        raise ValueError(f"dtcwt_qshift_masks: want float32 [B, 4, h1, w1], got "
                         f"{ll4.dtype} {tuple(ll4.shape)}")
    if ll4.shape[2] % 4 or ll4.shape[3] % 4:
        raise ValueError(f"dtcwt_qshift_masks requires h1, w1 % 4 == 0, got "
                         f"{tuple(ll4.shape[2:])}")


def dtcwt_qshift_masks_reference(ll4: torch.Tensor, step: float = 5.0) -> torch.Tensor:
    hp2, _ = Transform2d("torch").analysis_qshift_hp(ll4)
    m = filter2d_mean2x2(q2c_magnitudes(hp2))  # [B, 6, h2, w2]
    v = (((m[..., 0::2, 0::2] + m[..., 0::2, 1::2]) + m[..., 1::2, 0::2])
         + m[..., 1::2, 1::2]) * 0.25
    return torch.ceil(v / torch.full_like(v, step))


def dtcwt_qshift_masks(ll4: torch.Tensor, step: float = 5.0) -> torch.Tensor:
    """f32 [B, 4, h1, w1] tree lowpasses (h1, w1 % 4 == 0) -> [B, 6, h1/4,
    w1/4] quantized masks ceil(rebin(mean2x2(|level-2 subbands|)) / step),
    bands [LH+, LH-, HL+, HL-, HH+, HH-]."""
    _check(ll4)
    if not ll4.is_cuda:
        return dtcwt_qshift_masks_reference(ll4, step)
    ll4, bstride = batch_strided(ll4)
    b, _, h1, w1 = ll4.shape
    out = torch.empty((b, 6, h1 // 4, w1 // 4), dtype=torch.float32, device=ll4.device)
    _build.launch("vfp_dtcwt_qshift_masks", ll4.device, ll4.data_ptr(), out.data_ptr(), b, h1, w1,
                  bstride, float(step), _params_host().ctypes.data)
    dtcwt_qshift_masks.launches += 1
    return out


dtcwt_qshift_masks.launches = 0
