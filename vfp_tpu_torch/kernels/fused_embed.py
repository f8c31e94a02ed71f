"""Single-launch flagship embed and extract on u8 planes (CUDA: ``csrc/fused_embed.cu``).

Replaces the Pallas kernels ``fused_mark_planar`` and ``fused_extract_planar``
of ``vfp_tpu/kernels/fused_embed.py``.  Per 4x4 LL block (8x8 pixel tile):
channel lincomb -> Haar LL -> dominant triplet -> QIM -> rank-1 delta ->
2x2 upsample / 2 -> ``x + du * M_BWD[k, chan]``, clip, round-half-even, u8
(mark), or the QIM bit of s0 (extract).

Bound on the card: memory.  Mark reads and writes the frame once (3 B/pixel
each way), extract reads it once (3 B/pixel); the block math is a few hundred
FLOPs per 64 pixels, kept in registers by one thread per tile.  The Mosaic
workarounds of the TPU kernel (selection matmuls, strips and lane chunks,
the u8->i32->f32 hop, the aliased output) are not carried over, and any
``W % 4 == 0`` width is taken as it is.

Numerics of the TPU kernel, which the plain versions below mirror and which
differ from the codec's multi-op path (``wm/dwt_dct_svd.py``): the +0.5
chroma offset is added as +1.0 after the row pair-sum and the Haar 0.5 after
it, and the output is ``x + du * M_BWD[k, chan]`` with no colour roundtrip.
Marked pixels near a .5 rounding edge may therefore differ by 1 from the
multi-op path; decoded bits agree.

Each wrapper takes its plain version (``*_reference``) for a tensor on the
CPU and launches the kernel for a CUDA tensor; ``<wrapper>.launches`` counts
the launches.
"""

from __future__ import annotations

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


def _color_host(chan: int) -> np.ndarray:
    """[fwd row (3), 2*OFF_FWD[chan], bwd column (3)] as the kernel's float32 array."""
    return np.ascontiguousarray(np.concatenate([
        M_FWD[chan], [2.0 * OFF_FWD[chan]], M_BWD[:, chan]]).astype(np.float32))


def _strides_host(t: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(t.stride(), dtype=np.int64)


def _ll_blocks(planes: torch.Tensor, chan: int, nbh: int, nbw: int) -> torch.Tensor:
    """[B, 16, nbh*nbw] LL blocks with the TPU kernel's association."""
    x = planes[:, :, : 8 * nbh, : 8 * nbw].to(torch.float32)
    mf = [float(v) for v in M_FWD[chan]]
    cp = mf[0] * x[:, 0] + mf[1] * x[:, 1] + mf[2] * x[:, 2]
    llr = cp[:, 0::2] + cp[:, 1::2] + 2.0 * float(OFF_FWD[chan])  # row pair-sum, folded offset
    ll = 0.5 * llr[:, :, 0::2] + 0.5 * llr[:, :, 1::2]
    return image_to_soa(ll, 4)


# -- fused_mark_planar --------------------------------------------------------

def fused_mark_planar_reference(planes: torch.Tensor, wm2d: torch.Tensor, scale: float = 15.0,
                                chan: int = 1) -> torch.Tensor:
    b, _, h, w = planes.shape
    nbh, nbw = _grid(h, w)
    s0, u, v = _triplet_core(_rows(_ll_blocks(planes, chan, nbh, nbw)))
    ds = qim_target(s0, wm2d.reshape(1, -1).to(torch.float32), scale) - s0
    dll = torch.stack([0.5 * (ds * (u[r] * v[c])) for r in range(4) for c in range(4)], 1)
    du = soa_to_image(dll, 4 * nbh, 4 * nbw, 4)
    du = du.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)  # [B, 8nbh, 8nbw]
    out = planes.clone()
    for k in range(3):
        mk = float(M_BWD[k, chan])
        if mk == 0.0:
            continue  # pure passthrough, as in the kernel
        xk = planes[:, k, : 8 * nbh, : 8 * nbw].to(torch.float32)
        out[:, k, : 8 * nbh, : 8 * nbw] = torch.round(
            torch.clamp(xk + mk * du, 0.0, 255.0)).to(torch.uint8)
    return out


def fused_mark_planar(planes: torch.Tensor, wm2d: torch.Tensor, scale: float = 15.0,
                      chan: int = 1) -> torch.Tensor:
    """u8 planes [B, 3, H, W] (any strides) + bits [nbh, nbw] -> new marked planes.

    wm2d is the first nbh*nbw entries of the flat watermark plane, row-major.
    Requires W % 4 == 0.  The output has the input's strides, so marking
    ``frames.permute(0, 3, 1, 2)`` and permuting back gives a contiguous
    [B, H, W, 3] batch.
    """
    _check_planes(planes, "fused_mark_planar")
    b, _, h, w = planes.shape
    nbh, nbw = _grid(h, w)
    if wm2d.shape != (nbh, nbw):
        raise ValueError(f"fused_mark_planar: want bits [{nbh}, {nbw}], got {tuple(wm2d.shape)}")
    if not planes.is_cuda:
        return fused_mark_planar_reference(planes, wm2d, scale, chan)
    if wm2d.device != planes.device or wm2d.dtype != torch.float32 or not wm2d.is_contiguous():
        raise ValueError("fused_mark_planar: bits must be contiguous float32 on the planes' device")
    out = torch.empty_like(planes)
    # host arrays the launcher reads: held in locals for the call's duration
    xs, os_, color = _strides_host(planes), _strides_host(out), _color_host(chan)
    with torch.cuda.device(planes.device):
        _build.launch("vfp_fused_mark_planar", planes.data_ptr(), xs.ctypes.data,
                      out.data_ptr(), os_.ctypes.data, wm2d.data_ptr(), b, h, w, nbh, nbw,
                      float(scale), color.ctypes.data, _V0_HOST.ctypes.data)
    fused_mark_planar.launches += 1
    return out


fused_mark_planar.launches = 0


# -- fused_extract_planar -----------------------------------------------------

def fused_extract_planar_reference(planes: torch.Tensor, scale: float = 15.0,
                                   chan: int = 1) -> torch.Tensor:
    b, _, h, w = planes.shape
    nbh, nbw = _grid(h, w)
    s0, _, _ = _triplet_core(_rows(_ll_blocks(planes, chan, nbh, nbw)))
    return qim_bit(s0, scale).reshape(b, nbh, nbw)


def fused_extract_planar(planes: torch.Tensor, scale: float = 15.0, chan: int = 1) -> torch.Tensor:
    """u8 planes [B, 3, H, W] (any strides) -> decoded bits [B, nbh, nbw] (f32 0/1)."""
    _check_planes(planes, "fused_extract_planar")
    b, _, h, w = planes.shape
    nbh, nbw = _grid(h, w)
    if not planes.is_cuda:
        return fused_extract_planar_reference(planes, scale, chan)
    bits = torch.empty((b, nbh, nbw), dtype=torch.float32, device=planes.device)
    xs, color = _strides_host(planes), _color_host(chan)
    with torch.cuda.device(planes.device):
        _build.launch("vfp_fused_extract_planar", planes.data_ptr(), xs.ctypes.data,
                      bits.data_ptr(), b, nbh, nbw, float(scale), color.ctypes.data,
                      _V0_HOST.ctypes.data)
    fused_extract_planar.launches += 1
    return bits


fused_extract_planar.launches = 0
