"""DT-CWT analysis levels on the card (CUDA: ``csrc/dtcwt_level1.cu`` for
level 1, ``csrc/dtcwt_qshift.cu`` for the q-shift levels).

Each wrapper replaces Pallas kernels of ``vfp_tpu/kernels/dtcwt_level1.py``:

- ``dtcwt_level1_ll_y``: ``dtcwt_level1_analysis_ll_y`` and
  ``dtcwt_level1_ll_y_chain``; u8 frames [B, H, W, 3] -> the Y channel's 4
  tree lowpasses [B, 4, H/2, W/2] (the mark path's mask input);
- ``dtcwt_level1_ll_color``: ``dtcwt_level1_analysis_ll_color`` and
  ``dtcwt_level1_ll_color_chain``; u8 frames -> the Y (channel 0) and U
  (channel 1) tree lowpasses [B, 2, 4, H/2, W/2] (the detect path's input);
- ``dtcwt_level1_analysis``: ``dtcwt_level1_analysis``; f32 [B, H, W] -> the
  16 level-1 planes [ll*4, lh*4, hl*4, hh*4], tree combos (rt, ct)
  row-major (the watermark plane's spectrum, the transform at any depth);
- ``dtcwt_level1_analysis_ll``: ``dtcwt_level1_analysis_ll``; f32 [B, H, W]
  -> the 4 tree lowpasses [B, 4, H/2, W/2] (the codecs' path for float
  frames and frames of odd H or W);
- ``dtcwt_qshift_ll``: ``dtcwt_qshift_analysis_ll`` and
  ``dtcwt_qshift_ll_chain``; f32 tree lowpasses [B, 4, h, w] -> the next
  level's [B, 4, h/2, w/2];
- ``dtcwt_qshift_hp``: ``dtcwt_qshift_analysis_hp`` and
  ``dtcwt_qshift_hp_chain``; f32 [B, 4, h, w] -> the 12 highpass planes
  [B, 12, h/2, w/2], [lh*4, hl*4, hh*4];
- ``dtcwt_qshift_analysis``: ``dtcwt_qshift_analysis``; f32 [B, 4, h, w] ->
  all 16 planes [B, 16, h/2, w/2] (the transform at any depth).

All compute, per tree (rt, ct): a row pass down2(x, f, phase) along H, then a
column pass down2(., g, phase) along W, y[m] = sum_k f[k] * x[(2m + phase -
k) mod N] (``ops/dtcwt.py``): level 1 with the LeGall pair and phases (rt,
ct), the q-shift levels with tree rt's and tree ct's 14-tap filters at phase
0.  The chained and unchained Pallas twins differ only in their pad layout;
one kernel with modular indexing covers both and copies nothing.  The
q-shift wrappers take a view whose batch items are each contiguous
(``ll[:, 1]`` of the level-1 output, ``planes[:, :4]`` of a level's 16
planes) in place.  ``dtcwt_level1_analysis_ll`` reads any layout in place
through its (batch, row, column) strides (the Y channel of ``bgr_to_yuv``,
12 bytes a pixel apart, on the codec's float-frame mark path);
``dtcwt_level1_analysis`` copies a non-contiguous input first (no path gives
it one).

Every level-1 kernel is tiled (a tile of output positions a block, its pixel
window loaded once, each row-pass value computed once); the three lowpass
wrappers share one 8 x 32 tile of positions.

The plain versions (``*_reference``) are the plain transform's blocks
(``ops/dtcwt.py``), which fold every sum in the kernels' order: each channel
as ((M_FWD[ch,0] b + M_FWD[ch,1] g) + M_FWD[ch,2] r) + OFF_FWD[ch], then each
filter sum from k = 0 upward, rows before columns.  The kernels build with
``--fmad=false``, so both sides round alike.  Each wrapper takes its plain
version for a CPU tensor and launches the kernel for a CUDA tensor;
``.launches`` counts.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..ops import dtcwt_coeffs as C
from ..ops.color import M_FWD, OFF_FWD
from ..ops.dtcwt import Transform2d
from . import _build
from .dtcwt_masks import _params_host as _qshift_params_host, batch_strided
from .fused_dct_qim import _lincomb


@lru_cache(maxsize=None)
def _params_host() -> np.ndarray:
    """The kernels' constants in the order of ``L1Params`` in the .cu: LeGall
    h0 (5), h1 (3), then M_FWD[ch] (3) and OFF_FWD[ch] for Y and U."""
    return np.ascontiguousarray(np.concatenate(
        [C.LEGALL_H0, C.LEGALL_H1, M_FWD[0], OFF_FWD[:1], M_FWD[1], OFF_FWD[1:2]]
    ).astype(np.float32))


@lru_cache(maxsize=None)
def _params_ptr() -> int:
    """Host address of ``_params_host()`` (the cached array keeps it valid)."""
    return _params_host().ctypes.data


@lru_cache(maxsize=None)
def _qshift_params_ptr() -> int:
    return _qshift_params_host().ctypes.data


def _check(x: torch.Tensor, name: str, dtype, ndim: int) -> None:
    shape = x.shape
    if x.dtype != dtype or len(shape) != ndim or (ndim == 4 and shape[-1] != 3):
        want = "uint8 [B, H, W, 3]" if ndim == 4 else "float32 [B, H, W]"
        raise ValueError(f"{name}: want {want}, got {x.dtype} {tuple(shape)}")
    if shape[1] % 2 or shape[2] % 2:
        raise ValueError(f"{name} requires even H and W, got {tuple(shape[1:3])}")


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
    device = frames.device
    out = torch.empty((b, 4, h // 2, w // 2), dtype=torch.float32, device=device)
    _build.launch("vfp_dtcwt_level1_ll_y", device, frames.data_ptr(), out.data_ptr(), b,
                  h, w, _params_ptr())
    dtcwt_level1_ll_y.launches += 1
    return out


dtcwt_level1_ll_y.launches = 0


# -- dtcwt_level1_ll_color ---------------------------------------------------------

def dtcwt_level1_ll_color_reference(frames: torch.Tensor) -> torch.Tensor:
    planes = frames.permute(0, 3, 1, 2)
    yu = torch.stack([_lincomb(planes, 0), _lincomb(planes, 1)], dim=1)
    return Transform2d("torch").analysis_level1(yu, lowpass_only=True)[0]


def dtcwt_level1_ll_color(frames: torch.Tensor) -> torch.Tensor:
    """u8 frames [B, H, W, 3] (H, W even) -> f32 [B, 2, 4, H/2, W/2]: the 4
    level-1 tree lowpasses of Y (channel 0) and U (channel 1), combos (rt,
    ct) row-major; each pixel's bytes are read once for both channels."""
    _check(frames, "dtcwt_level1_ll_color", torch.uint8, 4)
    if not frames.is_cuda:
        return dtcwt_level1_ll_color_reference(frames)
    frames = frames.contiguous()
    b, h, w, _ = frames.shape
    device = frames.device
    out = torch.empty((b, 2, 4, h // 2, w // 2), dtype=torch.float32, device=device)
    _build.launch("vfp_dtcwt_level1_ll_color", device, frames.data_ptr(), out.data_ptr(),
                  b, h, w, _params_ptr())
    dtcwt_level1_ll_color.launches += 1
    return out


dtcwt_level1_ll_color.launches = 0


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
    _build.launch("vfp_dtcwt_level1_analysis", x.device, x.data_ptr(), out.data_ptr(), b, h, w,
                  _params_ptr())
    dtcwt_level1_analysis.launches += 1
    return out


dtcwt_level1_analysis.launches = 0


# -- dtcwt_level1_analysis_ll ------------------------------------------------------

def dtcwt_level1_analysis_ll_reference(x: torch.Tensor) -> torch.Tensor:
    return Transform2d("torch").analysis_level1(x, lowpass_only=True)[0]


def dtcwt_level1_analysis_ll(x: torch.Tensor) -> torch.Tensor:
    """f32 [B, H, W] (H, W even; any strides, read in place) -> [B, 4, H/2,
    W/2]: the 4 level-1 tree lowpasses, combos (rt, ct) row-major."""
    _check(x, "dtcwt_level1_analysis_ll", torch.float32, 3)
    if not x.is_cuda:
        return dtcwt_level1_analysis_ll_reference(x)
    b, h, w = x.shape
    out = torch.empty((b, 4, h // 2, w // 2), dtype=torch.float32, device=x.device)
    _build.launch("vfp_dtcwt_level1_analysis_ll", x.device, x.data_ptr(), out.data_ptr(), b, h,
                  w, *x.stride(), _params_ptr())
    dtcwt_level1_analysis_ll.launches += 1
    return out


dtcwt_level1_analysis_ll.launches = 0


# -- dtcwt_qshift_ll, dtcwt_qshift_hp, dtcwt_qshift_analysis --------------------------

def _check_ll4(ll4: torch.Tensor, name: str) -> None:
    if ll4.dtype != torch.float32 or ll4.dim() != 4 or ll4.shape[1] != 4:
        raise ValueError(f"{name}: want float32 [B, 4, h, w], got {ll4.dtype} "
                         f"{tuple(ll4.shape)}")
    if ll4.shape[2] % 2 or ll4.shape[3] % 2:
        raise ValueError(f"{name} requires even h and w, got {tuple(ll4.shape[2:])}")


def _launch_qshift(fn, name: str, ll4: torch.Tensor, planes: int) -> torch.Tensor:
    ll4, bstride = batch_strided(ll4)
    b, _, h, w = ll4.shape
    out = torch.empty((b, planes, h // 2, w // 2), dtype=torch.float32, device=ll4.device)
    _build.launch(name, ll4.device, ll4.data_ptr(), out.data_ptr(), b, h, w, bstride,
                  _qshift_params_ptr())
    fn.launches += 1
    return out


def dtcwt_qshift_ll_reference(ll4: torch.Tensor) -> torch.Tensor:
    return Transform2d("torch").analysis_qshift(ll4, lowpass_only=True)[0]


def dtcwt_qshift_ll(ll4: torch.Tensor) -> torch.Tensor:
    """f32 tree lowpasses [B, 4, h, w] (h, w even) -> the next q-shift
    level's tree lowpasses [B, 4, h/2, w/2]."""
    _check_ll4(ll4, "dtcwt_qshift_ll")
    if not ll4.is_cuda:
        return dtcwt_qshift_ll_reference(ll4)
    return _launch_qshift(dtcwt_qshift_ll, "vfp_dtcwt_qshift_ll", ll4, 4)


dtcwt_qshift_ll.launches = 0


def dtcwt_qshift_hp_reference(ll4: torch.Tensor) -> torch.Tensor:
    return Transform2d("torch").analysis_qshift_hp(ll4)[0]


def dtcwt_qshift_hp(ll4: torch.Tensor) -> torch.Tensor:
    """f32 tree lowpasses [B, 4, h, w] (h, w even) -> the q-shift level's 12
    highpass planes [B, 12, h/2, w/2], [lh*4, hl*4, hh*4]."""
    _check_ll4(ll4, "dtcwt_qshift_hp")
    if not ll4.is_cuda:
        return dtcwt_qshift_hp_reference(ll4)
    return _launch_qshift(dtcwt_qshift_hp, "vfp_dtcwt_qshift_hp", ll4, 12)


dtcwt_qshift_hp.launches = 0


def dtcwt_qshift_analysis_reference(ll4: torch.Tensor) -> torch.Tensor:
    return Transform2d("torch").analysis_qshift(ll4)[0]


def dtcwt_qshift_analysis(ll4: torch.Tensor) -> torch.Tensor:
    """f32 tree lowpasses [B, 4, h, w] (h, w even) -> one full q-shift level,
    [B, 16, h/2, w/2] planes [ll*4, lh*4, hl*4, hh*4]."""
    _check_ll4(ll4, "dtcwt_qshift_analysis")
    if not ll4.is_cuda:
        return dtcwt_qshift_analysis_reference(ll4)
    return _launch_qshift(dtcwt_qshift_analysis, "vfp_dtcwt_qshift_analysis", ll4, 16)


dtcwt_qshift_analysis.launches = 0
