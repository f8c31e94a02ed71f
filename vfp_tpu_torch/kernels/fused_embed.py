"""Single-launch flagship embed and extract on u8 planes (CUDA: ``csrc/fused_embed.cu``).

Replaces the Pallas kernels ``fused_mark_planar`` and ``fused_extract_planar``
of ``vfp_tpu/kernels/fused_embed.py``.  Per 4x4 LL block (8x8 pixel tile):
channel lincomb -> Haar LL -> dominant triplet -> QIM -> rank-1 delta ->
2x2 upsample / 2 -> ``x + du * M_BWD[k, chan]``, clip, round-half-even, u8
(mark), or the QIM bit of s0 (extract).

Bound on the card: memory.  Mark reads and writes the frame once (3 B/pixel
each way), extract reads it once (3 B/pixel); the block math is a few hundred
FLOPs per 64 pixels, done by one thread per tile.  Mark stages a strip of 8
tile rows x 16 tiles in shared memory with 16- or 4-byte copies on the
interleaved view (byte by byte through the strides on any other layout) and
writes its output bytes 16 or 4 at a time.  The Mosaic workarounds of the
TPU kernel (selection matmuls, strips and lane chunks, the u8->i32->f32 hop,
the aliased output) are not carried over, and any ``W % 4 == 0`` width is
taken as it is.

Numerics of the TPU kernel, which the plain versions below mirror and which
differ from the codec's multi-op path (``wm/dwt_dct_svd.py``): the +0.5
chroma offset is added as +1.0 after the row pair-sum and the Haar 0.5 after
it, and the output is ``x + du * M_BWD[k, chan]`` with no colour roundtrip.
Marked pixels near a .5 rounding edge may therefore differ by 1 from the
multi-op path; decoded bits agree.

``int_path=True`` takes the TPU kernels' second body (their static
``int_path``): the colour row as integers at 2^14 (``_MAC_SH``), an exact
int32 row pair-sum converted once to float32, and for the mark an integer
epilogue at 2^20, ``(x << 20) + round(1024 du) * round(1024 M_BWD[k, chan])
+ 2^19`` shifted right by 20 (half up) and clamped.  It marks ~2% of pixels
differently from the float32 body; decoded bits agree.

Each wrapper takes its plain version (``*_reference``) for a tensor on the
CPU and launches the kernel for a CUDA tensor; ``<wrapper>.launches`` counts
the float32 body's launches, ``<wrapper>.int_launches`` the integer body's.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..ops.color import M_BWD, M_FWD, OFF_FWD
from ..ops.soa import image_to_soa, soa_to_image
from . import _build
from .qim import _V0_HOST, _rows, _triplet_core, qim_bit, qim_target


def _grid(h: int, w: int):
    """(nbh, nbw): the LL block grid of an H x W frame (blk 4, 4-aligned crop)."""
    return (h // 4 * 4 // 2) // 4, (w // 4 * 4) // 8


def _check_planes(planes: torch.Tensor, name: str) -> None:
    if planes.dtype != torch.uint8 or planes.dim() != 4 or planes.shape[1] != 3:
        raise ValueError(f"{name}: want uint8 planes [B, 3, H, W], got "
                         f"{planes.dtype} {tuple(planes.shape)}")
    if planes.shape[3] % 4:
        raise ValueError(f"{name} requires W % 4 == 0, got W={planes.shape[3]}")


# Per channel, [fwd row (3), 2*OFF_FWD[chan], bwd column (3)] as the
# kernel's float32 array, and the host addresses the launchers read (the
# arrays live as long as the module).
_COLOR_HOST = {chan: np.ascontiguousarray(np.concatenate([
    M_FWD[chan], [2.0 * OFF_FWD[chan]], M_BWD[:, chan]]).astype(np.float32)) for chan in range(3)}
_COLOR_PTR = {chan: a.ctypes.data for chan, a in _COLOR_HOST.items()}
_V0_PTR = _V0_HOST.ctypes.data

# The integer body's fixed point, as the TPU kernel's: the colour row at 2^14
# (every pair-sum of two u8 pixels' rows is below 2^24, so its one conversion
# to float32 is exact) and du and the backward column at 2^10 each.
_MAC_SH = 14
_EPI_SH = 10
INT_FWD = {chan: [int(round(float(M_FWD[chan, i]) * (1 << _MAC_SH))) for i in range(3)]
           for chan in range(3)}
INT_BWD = {chan: [int(round(float(M_BWD[k, chan]) * (1 << _EPI_SH))) for k in range(3)]
           for chan in range(3)}
# Per channel, [fwd row (3 int32), 2*OFF_FWD[chan] (float32 bits), bwd column
# (3 int32)]: the integer launchers' array, laid out as csrc/fused_embed.cu's
# Coef<true>.
_INT_COLOR_HOST = {chan: np.ascontiguousarray(np.concatenate([
    INT_FWD[chan], np.array([2.0 * OFF_FWD[chan]], np.float32).view(np.int32),
    INT_BWD[chan]]).astype(np.int32)) for chan in range(3)}
_INT_COLOR_PTR = {chan: a.ctypes.data for chan, a in _INT_COLOR_HOST.items()}


def _strides_arg(t: torch.Tensor) -> ctypes.Array:
    """The 4 int64 strides as a host array the launcher reads during the call."""
    return (ctypes.c_longlong * 4)(*t.stride())


def _ll_blocks(planes: torch.Tensor, chan: int, nbh: int, nbw: int,
               int_path: bool = False) -> torch.Tensor:
    """[B, 16, nbh*nbw] LL blocks with the TPU kernel's association."""
    off2 = 2.0 * float(OFF_FWD[chan])
    if int_path:
        x = planes[:, :, : 8 * nbh, : 8 * nbw].to(torch.int32)
        mi = INT_FWD[chan]
        cp = mi[0] * x[:, 0] + mi[1] * x[:, 1] + mi[2] * x[:, 2]
        # exact int32 row pair-sum, one exact conversion, an exact power-of-two scale
        llr = (cp[:, 0::2] + cp[:, 1::2]).to(torch.float32) * 2.0 ** -_MAC_SH + off2
    else:
        x = planes[:, :, : 8 * nbh, : 8 * nbw].to(torch.float32)
        mf = [float(v) for v in M_FWD[chan]]
        cp = mf[0] * x[:, 0] + mf[1] * x[:, 1] + mf[2] * x[:, 2]
        llr = cp[:, 0::2] + cp[:, 1::2] + off2  # row pair-sum, folded offset
    ll = 0.5 * llr[:, :, 0::2] + 0.5 * llr[:, :, 1::2]
    return image_to_soa(ll, 4)


# -- fused_mark_planar --------------------------------------------------------

def fused_mark_planar_reference(planes: torch.Tensor, wm2d: torch.Tensor, scale: float = 15.0,
                                chan: int = 1, int_path: bool = False) -> torch.Tensor:
    b, _, h, w = planes.shape
    nbh, nbw = _grid(h, w)
    s0, u, v = _triplet_core(_rows(_ll_blocks(planes, chan, nbh, nbw, int_path)))
    ds = qim_target(s0, wm2d.reshape(1, -1).to(torch.float32), scale) - s0
    dll = torch.stack([0.5 * (ds * (u[r] * v[c])) for r in range(4) for c in range(4)], 1)
    du = soa_to_image(dll, 4 * nbh, 4 * nbw, 4)
    du = du.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)  # [B, 8nbh, 8nbw]
    if int_path:  # du at 2^10: exact, then rounded half to even
        duq = torch.round((1 << _EPI_SH) * du).to(torch.int32)
    out = planes.clone()
    for k in range(3):
        mk = float(M_BWD[k, chan])
        if mk == 0.0:
            continue  # pure passthrough, as in the kernel
        if int_path:  # at 2^20, the arithmetic shift rounds half up
            xk = planes[:, k, : 8 * nbh, : 8 * nbw].to(torch.int32)
            v = (xk << 2 * _EPI_SH) + duq * INT_BWD[chan][k] + (1 << (2 * _EPI_SH - 1))
            out[:, k, : 8 * nbh, : 8 * nbw] = torch.clamp(v >> 2 * _EPI_SH, 0, 255).to(torch.uint8)
            continue
        xk = planes[:, k, : 8 * nbh, : 8 * nbw].to(torch.float32)
        out[:, k, : 8 * nbh, : 8 * nbw] = torch.round(
            torch.clamp(xk + mk * du, 0.0, 255.0)).to(torch.uint8)
    return out


def fused_mark_planar(planes: torch.Tensor, wm2d: torch.Tensor, scale: float = 15.0,
                      chan: int = 1, int_path: bool = False) -> torch.Tensor:
    """u8 planes [B, 3, H, W] (any strides) + bits [nbh, nbw] -> new marked planes.

    wm2d is the first nbh*nbw entries of the flat watermark plane, row-major.
    Requires W % 4 == 0.  The output has the input's strides, so marking
    ``frames.permute(0, 3, 1, 2)`` and permuting back gives a contiguous
    [B, H, W, 3] batch.  ``int_path``: the integer body (module docstring).
    """
    _check_planes(planes, "fused_mark_planar")
    b, _, h, w = planes.shape
    nbh, nbw = _grid(h, w)
    if wm2d.shape != (nbh, nbw):
        raise ValueError(f"fused_mark_planar: want bits [{nbh}, {nbw}], got {tuple(wm2d.shape)}")
    if not planes.is_cuda:
        return fused_mark_planar_reference(planes, wm2d, scale, chan, int_path)
    if wm2d.device != planes.device or wm2d.dtype != torch.float32 or not wm2d.is_contiguous():
        raise ValueError("fused_mark_planar: bits must be contiguous float32 on the planes' device")
    out = torch.empty_like(planes)
    _build.launch("vfp_fused_mark_planar_int" if int_path else "vfp_fused_mark_planar",
                  planes.device, planes.data_ptr(), _strides_arg(planes), out.data_ptr(),
                  _strides_arg(out), wm2d.data_ptr(), b, h, w, nbh, nbw, float(scale),
                  (_INT_COLOR_PTR if int_path else _COLOR_PTR)[chan], _V0_PTR)
    if int_path:
        fused_mark_planar.int_launches += 1
    else:
        fused_mark_planar.launches += 1
    return out


fused_mark_planar.launches = 0
fused_mark_planar.int_launches = 0


# -- fused_extract_planar -----------------------------------------------------

def fused_extract_planar_reference(planes: torch.Tensor, scale: float = 15.0,
                                   chan: int = 1, int_path: bool = False) -> torch.Tensor:
    b, _, h, w = planes.shape
    nbh, nbw = _grid(h, w)
    s0, _, _ = _triplet_core(_rows(_ll_blocks(planes, chan, nbh, nbw, int_path)))
    return qim_bit(s0, scale).reshape(b, nbh, nbw)


def fused_extract_planar(planes: torch.Tensor, scale: float = 15.0, chan: int = 1,
                         int_path: bool = False) -> torch.Tensor:
    """u8 planes [B, 3, H, W] (any strides) -> decoded bits [B, nbh, nbw] (f32 0/1).
    ``int_path``: the integer LL body (module docstring)."""
    _check_planes(planes, "fused_extract_planar")
    b, _, h, w = planes.shape
    nbh, nbw = _grid(h, w)
    if not planes.is_cuda:
        return fused_extract_planar_reference(planes, scale, chan, int_path)
    bits = torch.empty((b, nbh, nbw), dtype=torch.float32, device=planes.device)
    _build.launch("vfp_fused_extract_planar_int" if int_path else "vfp_fused_extract_planar",
                  planes.device, planes.data_ptr(), _strides_arg(planes), bits.data_ptr(), b,
                  nbh, nbw, float(scale), (_INT_COLOR_PTR if int_path else _COLOR_PTR)[chan],
                  _V0_PTR)
    if int_path:
        fused_extract_planar.int_launches += 1
    else:
        fused_extract_planar.launches += 1
    return bits


fused_extract_planar.launches = 0
fused_extract_planar.int_launches = 0
