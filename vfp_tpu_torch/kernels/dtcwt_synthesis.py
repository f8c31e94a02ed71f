"""DT-CWT synthesis levels on the card (CUDA: ``csrc/dtcwt_synthesis.cu``).

Each wrapper replaces the Pallas kernel of the same name in
``vfp_tpu/kernels/dtcwt_synthesis.py``; planes are [ll*4, lh*4, hl*4, hh*4]
with tree combos (rt, ct) row-major within each band, and every output is
the whole [2h, 2w] grid, before any crop:

- ``dtcwt_qshift_synthesis``: one q-shift level, [B, 16, h, w] -> the level
  below's 4 tree lowpasses [B, 4, 2h, 2w];
- ``dtcwt_qshift_synthesis_ll``: the same with zero highpasses, [B, 4, h, w]
  -> [B, 4, 2h, 2w] (the embed delta above its level);
- ``dtcwt_legall_synthesis``: the LeGall level 1, [B, 16, h, w] -> the
  4-tree average [B, 2h, 2w];
- ``dtcwt_legall_synthesis_ll``: the same with zero highpasses, [B, 4, h, w]
  -> [B, 2h, 2w];
- ``dtcwt_legall_synthesis_hp``: the same with a zero lowpass, [B, 12, h, w]
  planes [lh*4, hl*4, hh*4] -> [B, 2h, 2w] (the decode).

Per tree, with y2 the zero-upsampled input (y2[2a + p] = y[a]), every stage
computes

    up2(y, f, p)[n] = sum_k f[k] * y2[(n - k) mod 2N]      (k from 0 upward,
                                                            the zero taps skipped)

columns first (lo = up2(ll, g0c) + up2(lh, g1c), hi = up2(hl, g0c) +
up2(hh, g1c)), then rows (up2(lo, g0r) + up2(hi, g1r)), then the rolls
(``QSHIFT_ROLL_*`` per tree, ``LEGALL_ROLL``), as ``ops/dtcwt.py:Transform2d``
does; LeGall sums the 4 trees in order and multiplies by 0.25.  Odd h and w
are taken as they are.  A strided input (a cropped level) is copied first.

The plain versions (``*_reference``) are those blocks of the plain
transform.  They fold over every tap of the zero-upsampled input, the zeros
included, and the kernels skip the zero terms; adding a zero leaves a float
sum unchanged, so both round alike (``--fmad=false``).
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


@lru_cache(maxsize=None)
def _qparams_host() -> np.ndarray:
    """g0a, g1a, g0b, g1b (14 each), then the rolls of trees a and b as
    floats, in the order of ``QSynParams``."""
    return np.ascontiguousarray(np.concatenate(
        [C.QSHIFT_G0A, C.QSHIFT_G1A, C.QSHIFT_G0B, C.QSHIFT_G1B,
         [C.QSHIFT_ROLL_A, C.QSHIFT_ROLL_B]]).astype(np.float32))


def _check(x: torch.Tensor, name: str, planes: int) -> None:
    if x.dtype != torch.float32 or x.dim() != 4 or x.shape[1] != planes:
        raise ValueError(f"{name}: want float32 [B, {planes}, h, w], got {x.dtype} "
                         f"{tuple(x.shape)}")


def _launch(fn, name: str, x: torch.Tensor, out_planes: int, params: np.ndarray) -> torch.Tensor:
    """[B, P, h, w] -> [B, out_planes, 2h, 2w] ([B, 2h, 2w] for one plane)."""
    x = x.contiguous()
    b, _, h, w = x.shape
    shape = (b, 2 * h, 2 * w) if out_planes == 1 else (b, out_planes, 2 * h, 2 * w)
    out = torch.empty(shape, dtype=torch.float32, device=x.device)
    _build.launch(name, x.device, x.data_ptr(), out.data_ptr(), b, h, w, params.ctypes.data)
    fn.launches += 1
    return out


# -- the q-shift levels ----------------------------------------------------------------

def dtcwt_qshift_synthesis_reference(planes16: torch.Tensor) -> torch.Tensor:
    return Transform2d("torch").synthesis_qshift(planes16)


def dtcwt_qshift_synthesis(planes16: torch.Tensor) -> torch.Tensor:
    """f32 [B, 16, h, w] -> [B, 4, 2h, 2w] tree lowpasses of the level below."""
    _check(planes16, "dtcwt_qshift_synthesis", 16)
    if not planes16.is_cuda:
        return dtcwt_qshift_synthesis_reference(planes16)
    return _launch(dtcwt_qshift_synthesis, "vfp_dtcwt_qshift_synthesis", planes16, 4,
                   _qparams_host())


dtcwt_qshift_synthesis.launches = 0


def dtcwt_qshift_synthesis_ll_reference(ll4: torch.Tensor) -> torch.Tensor:
    return Transform2d("torch").synthesis_qshift_ll(ll4)


def dtcwt_qshift_synthesis_ll(ll4: torch.Tensor) -> torch.Tensor:
    """f32 tree lowpasses [B, 4, h, w] (zero highpasses) -> [B, 4, 2h, 2w]."""
    _check(ll4, "dtcwt_qshift_synthesis_ll", 4)
    if not ll4.is_cuda:
        return dtcwt_qshift_synthesis_ll_reference(ll4)
    return _launch(dtcwt_qshift_synthesis_ll, "vfp_dtcwt_qshift_synthesis_ll", ll4, 4,
                   _qparams_host())


dtcwt_qshift_synthesis_ll.launches = 0


# -- the LeGall level 1 ----------------------------------------------------------------

def dtcwt_legall_synthesis_reference(planes16: torch.Tensor) -> torch.Tensor:
    return Transform2d("torch").synthesis_legall(planes16)


def dtcwt_legall_synthesis(planes16: torch.Tensor) -> torch.Tensor:
    """f32 [B, 16, h, w] level-1 planes -> [B, 2h, 2w]."""
    _check(planes16, "dtcwt_legall_synthesis", 16)
    if not planes16.is_cuda:
        return dtcwt_legall_synthesis_reference(planes16)
    return _launch(dtcwt_legall_synthesis, "vfp_dtcwt_legall_synthesis", planes16, 1,
                   _params_host())


dtcwt_legall_synthesis.launches = 0


def dtcwt_legall_synthesis_ll_reference(ll4: torch.Tensor) -> torch.Tensor:
    return Transform2d("torch").synthesis_legall_ll(ll4)


def dtcwt_legall_synthesis_ll(ll4: torch.Tensor) -> torch.Tensor:
    """f32 level-1 tree lowpasses [B, 4, h, w] (zero highpasses) -> [B, 2h, 2w]."""
    _check(ll4, "dtcwt_legall_synthesis_ll", 4)
    if not ll4.is_cuda:
        return dtcwt_legall_synthesis_ll_reference(ll4)
    return _launch(dtcwt_legall_synthesis_ll, "vfp_dtcwt_legall_synthesis_ll", ll4, 1,
                   _params_host())


dtcwt_legall_synthesis_ll.launches = 0


def dtcwt_legall_synthesis_hp_reference(subs12: torch.Tensor) -> torch.Tensor:
    return Transform2d("torch").synthesis_legall_hp(subs12)


def dtcwt_legall_synthesis_hp(subs12: torch.Tensor) -> torch.Tensor:
    """f32 [B, 12, h, w] level-1 highpass planes -> [B, 2h, 2w]."""
    _check(subs12, "dtcwt_legall_synthesis_hp", 12)
    if not subs12.is_cuda:
        return dtcwt_legall_synthesis_hp_reference(subs12)
    return _launch(dtcwt_legall_synthesis_hp, "vfp_dtcwt_legall_synthesis_hp", subs12, 1,
                   _params_host())


dtcwt_legall_synthesis_hp.launches = 0
