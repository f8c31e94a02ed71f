"""Single-launch DCT-QIM embed, extract on u8 planes that reads each frame
once, and the one-launch Y mean (CUDA: ``csrc/fused_dct_qim.cu``).

Replaces the Pallas kernels ``fused_dct_qim_mark`` and ``fused_dct_qim_extract``
of ``vfp_tpu/kernels/fused_dct_qim.py`` and its XLA pre-pass ``_y_dc_mean``.
Per 8x8 tile: Y and U lincombs -> separable 8x8 DCT of Y (D·Y·Dᵀ) and the
one U coefficient [2][1] -> luminance and texture masks -> step = alpha *
mask -> QIM on the U coefficient -> the rank-1 spatial delta amp * basis
with basis = outer(D[2], D[1]) -> ``x + M_BWD[k, 1] * du``, clip,
round-half-even, u8 (mark), or the bit of round(v / step) (extract).
The mark stages a strip of 4 x 16 tiles in shared memory and splits each
tile's row pass, column pass and mask over the block's threads; the extract
keeps one thread per tile.  Both read the planes through their strides
(the codec passes the interleaved view of its frame batch, no copy).

The luminance mask needs each frame's mean Y over the 8-aligned crop (the
mean of the blocks' DC / 8).  Every Y value is a multiple of 2^-27 below
2^8 (``Y_SCALE``, from the smallest Y coefficient's exponent), so a frame's
sum of Y * 2^27 in int64 is exact in any order: ``y_dc_mean`` is one launch
that reduces with atomics and still equals its plain version bit for bit.
The mark takes precomputed ``means`` (so a comparison can feed one set to
a kernel and its plain version) or ``y_dc_mean``'s; the extract, as the
Pallas one, takes each frame's mean itself: its first launch sums the Y
values its own row pass computes, a second, small launch decides the bits,
so the frame is read once.

The plain versions (``*_reference``) repeat the kernels' arithmetic in the
kernels' order: separable DCT sums as left folds, IEEE division by tensors
(PyTorch's CUDA division by a Python scalar is a reciprocal multiply), the
reference's unguarded texture-mask divisions.  They are the Pallas
kernels' numerics, not the codec's multi-op path (``wm/dct_qim.py``), which
inverts the whole DCT and takes the colour roundtrip: marked pixels near a
.5 rounding edge may differ by 1 between the two, as the Pallas kernels
already document.

Each wrapper takes its plain version for a tensor on the CPU and launches
the kernel for a CUDA tensor; ``<wrapper>.launches`` counts its kernel's
launches, and ``fused_dct_qim_extract.decide_launches`` those of the
extract's second kernel.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..ops.color import M_BWD, M_FWD, OFF_FWD
from ..ops.dct import dct_matrix
from . import _build

COEFF = (2, 1)  # the U coefficient that carries the bit
EXTRACT_BLOCK = 128  # tiles a block of the CUDA extract (kThreads in the .cu)


def _y_scale() -> float:
    """2^27: Y * 2^27 is an integer for every u8 pixel.  Y's coefficients are
    non-negative float32 and its offset is 0, so each product and each
    rounded sum of the lincomb is a multiple of the smallest coefficient's
    ulp (float32 keeps 24 significant bits)."""
    m = M_FWD[0]
    assert (m >= 0).all() and OFF_FWD[0] == 0, (M_FWD[0], OFF_FWD[0])
    _, exp = np.frexp(m[m > 0])  # m = f * 2^exp with f in [0.5, 1)
    return float(2.0 ** (24 - int(exp.min())))


Y_SCALE = _y_scale()
# The kernels form row 4 of D's products from row 0's with these signs
# (csrc/fused_dct_qim.cu:dct8), which holds bit for bit for the DCT-II.
DCT_SIGN4 = np.array([1, -1, -1, 1, 1, -1, -1, 1], np.float32)
assert np.array_equal(dct_matrix(8)[4], dct_matrix(8)[0] * DCT_SIGN4)


@lru_cache(maxsize=None)
def _basis() -> np.ndarray:
    """outer(D[2], D[1]) [8, 8]: the spatial pattern of DCT coefficient [2][1]
    (idct2 of e2 e1ᵀ), so a change ``amp`` of that coefficient is ``amp * basis``."""
    d8 = dct_matrix(8)
    return np.outer(d8[COEFF[0]], d8[COEFF[1]]).astype(np.float32)


@lru_cache(maxsize=None)
def _params_host() -> np.ndarray:
    """The kernels' constants as one float32 array in the order of ``Params``
    in the .cu: D (64), basis (64), M_FWD[0] (3), M_FWD[1] (3), OFF_FWD[1],
    M_BWD[:, 1] (3).  Y's zero offset is left out (``_y_scale`` asserts it)."""
    return np.ascontiguousarray(np.concatenate([
        dct_matrix(8).reshape(-1), _basis().reshape(-1), M_FWD[0], M_FWD[1], OFF_FWD[1:2],
        M_BWD[:, 1],
    ]).astype(np.float32))


def _strides_host(t: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(t.stride(), dtype=np.int64)


def _check_planes(planes: torch.Tensor, name: str) -> None:
    if planes.dtype != torch.uint8 or planes.dim() != 4 or planes.shape[1] != 3:
        raise ValueError(f"{name}: want uint8 planes [B, 3, H, W], got "
                         f"{planes.dtype} {tuple(planes.shape)}")
    if planes.shape[2] % 8 or planes.shape[3] % 8:
        raise ValueError(f"{name} requires H, W % 8 == 0, got {tuple(planes.shape[2:])}")


def true_div(a: torch.Tensor, s: float) -> torch.Tensor:
    """``a / s`` as an IEEE division on every device: PyTorch's CUDA division
    by a Python scalar is a multiply by its reciprocal, which can move a
    quotient across a rounding or QIM-bin edge."""
    return a / torch.full_like(a, s)


def _lincomb(planes: torch.Tensor, chan: int) -> torch.Tensor:
    """[B, 3, H, W] u8 -> channel ``chan`` of YUV [B, H, W] f32, as the kernel
    sums it; one channel's float copy at a time."""
    m = [float(v) for v in M_FWD[chan]]
    acc = m[0] * planes[:, 0].to(torch.float32)
    acc = acc + m[1] * planes[:, 1].to(torch.float32)
    return (acc + m[2] * planes[:, 2].to(torch.float32)) + float(OFF_FWD[chan])


def _tiles(img: torch.Tensor) -> torch.Tensor:
    """[B, H, W] -> [B, H/8, W/8, 8, 8]."""
    b, h, w = img.shape
    return img.reshape(b, h // 8, 8, w // 8, 8).permute(0, 1, 3, 2, 4)


def _untile(t: torch.Tensor) -> torch.Tensor:
    b, nbh, nbw = t.shape[:3]
    return t.permute(0, 1, 3, 2, 4).reshape(b, 8 * nbh, 8 * nbw)


def _fold(terms):
    acc = terms[0]
    for x in terms[1:]:
        acc = acc + x
    return acc


def _qim_inputs(planes: torch.Tensor, means: torch.Tensor, alpha: float):
    """(v, step), each [B, nbh, nbw]: the U coefficient [2][1] of every tile
    and its QIM step, in the kernel's operation order."""
    d = torch.as_tensor(dct_matrix(8), device=planes.device)
    y = _tiles(_lincomb(planes, 0))  # [B, nbh, nbw, r, i]
    u = _tiles(_lincomb(planes, 1))
    # row pass: rows[..., r, q] = sum_i Y[r][i] * D[q][i]
    rows = _fold([y[..., i : i + 1] * d[:, i] for i in range(8)])
    # column pass: c[..., p, q] = sum_r D[p][r] * rows[r][q]
    c = _fold([d[:, r, None] * rows[..., r : r + 1, :] for r in range(8)])
    t = _fold([u[..., i] * d[COEFF[1], i] for i in range(8)])  # [..., r]
    v = _fold([d[COEFF[0], r] * t[..., r] for r in range(8)])

    a = c.abs().reshape(*c.shape[:3], 64)

    def at(p, q):
        return a[..., p * 8 + q]

    total = _fold([a[..., i] for i in range(64)])
    dcl = at(0, 0) + at(0, 1) + at(0, 2) + at(1, 0) + at(1, 1) + at(2, 0)
    eh = total - dcl
    e = (at(3, 0) + at(4, 0) + at(5, 0) + at(6, 0) + at(0, 3) + at(0, 4) + at(0, 5) + at(0, 6)
         + at(2, 1) + at(1, 2) + at(2, 2) + at(3, 3))
    h = eh - e
    l = dcl - at(0, 0)
    l_e = l / e  # unguarded, as the reference: flat tiles give inf or NaN
    le_h = (l + e) / h

    def edge(p, q):
        return ((l_e >= p) & (le_h >= q)) | ((l_e >= q) & (le_h >= p)) | (le_h > 4.0)

    one = torch.ones_like(eh)
    edge_val = torch.where(l + e <= 400.0, 1.125 * one, 1.25 * one)
    ramp = 1.0 + true_div(1.25 * (eh - 290.0), 1510.0)
    hi = torch.where(edge(1.4, 1.1), edge_val, ramp)
    lo = torch.where(edge(2.3, 1.6), edge_val, torch.where(e + h > 290.0, ramp, one))
    tex = torch.where(eh > 125.0, torch.where(eh > 900.0, hi, lo), one)

    dc = true_div(c[..., 0, 0], 8.0)
    m = torch.clamp(means.to(torch.float32), min=90.0)[:, None, None].expand_as(dc)
    f_ref = 1.0 + true_div((m - 90.0) * 1.0, 165.0)
    lramp = 1.0 + (dc - m) / (255.0 - m) * (2.0 - f_ref)
    lum = torch.where(dc > m, lramp,
                      torch.where(dc < 15.0, 1.25 * one,
                                  torch.where(dc < 25.0, 1.125 * one, one)))
    return v, alpha * (tex * lum)


# -- y_dc_mean ----------------------------------------------------------------

def y_fixed_sums(planes: torch.Tensor) -> torch.Tensor:
    """[B, 3, H, W] u8 -> [B] int64: each frame's sum of Y * ``Y_SCALE`` over
    the 8-aligned crop, exact (each term is an integer below 2^35)."""
    h8, w8 = planes.shape[2] // 8 * 8, planes.shape[3] // 8 * 8
    y = _lincomb(planes[:, :, :h8, :w8], 0)
    return (y.to(torch.float64) * Y_SCALE).to(torch.int64).sum(dim=(1, 2))


def y_dc_mean_reference(planes: torch.Tensor) -> torch.Tensor:
    """[B, 3, H, W] u8 -> [B] f32 mean of Y over the 8-aligned crop, from the
    exact fixed-point sum by the kernels' float64 steps: S -> double,
    * 2^-27, IEEE division by the pixel count, -> float32."""
    count = (planes.shape[2] // 8 * 8) * (planes.shape[3] // 8 * 8)
    sums = y_fixed_sums(planes).to(torch.float64) * (1.0 / Y_SCALE)
    return true_div(sums, float(count)).to(torch.float32)


def y_dc_mean(planes: torch.Tensor) -> torch.Tensor:
    """[B, 3, H, W] u8 planes (any strides) -> [B] f32 per-frame mean of Y over
    the 8-aligned crop: the mean over blocks of DC / 8, which the luminance
    mask compares each block with."""
    if planes.dtype != torch.uint8 or planes.dim() != 4 or planes.shape[1] != 3:
        raise ValueError(f"y_dc_mean: want uint8 planes [B, 3, H, W], got "
                         f"{planes.dtype} {tuple(planes.shape)}")
    if not planes.is_cuda:
        return y_dc_mean_reference(planes)
    b, _, h, w = planes.shape
    means = torch.empty(b, dtype=torch.float32, device=planes.device)
    # the frames' fixed-point sums and the kernel's arrival counts start at 0
    totals = torch.zeros(2 * b, dtype=torch.int64, device=planes.device)
    xs = _strides_host(planes)
    _build.launch("vfp_y_dc_mean", planes.device, planes.data_ptr(), xs.ctypes.data,
                  totals.data_ptr(), means.data_ptr(), b, h // 8 * 8, w // 8 * 8,
                  _params_host().ctypes.data)
    y_dc_mean.launches += 1
    return means


y_dc_mean.launches = 0


def _check_means(planes: torch.Tensor, means: torch.Tensor, name: str) -> None:
    if means.shape != (planes.shape[0],):
        raise ValueError(f"{name}: want means [{planes.shape[0]}], got {tuple(means.shape)}")
    if planes.is_cuda and (means.device != planes.device or means.dtype != torch.float32
                           or not means.is_contiguous()):
        raise ValueError(f"{name}: means must be contiguous float32 on the planes' device")


# -- fused_dct_qim_mark ---------------------------------------------------------

def fused_dct_qim_mark_reference(planes: torch.Tensor, wm2d: torch.Tensor, alpha: float = 20.0,
                                 means: torch.Tensor | None = None) -> torch.Tensor:
    if means is None:
        means = y_dc_mean_reference(planes)
    v, step = _qim_inputs(planes, means, alpha)
    step2 = step + step
    sg = torch.sign(v)  # 0 at 0, as jnp.sign
    base = sg * torch.floor(v.abs() / step2) * step2
    bits = wm2d.to(device=v.device, dtype=torch.float32)
    amp = torch.where(bits == 0.0, base, base + sg * step) - v
    basis = torch.as_tensor(_basis(), device=planes.device)
    du = _untile(amp[..., None, None] * basis)  # [B, H, W]
    out = planes.clone()
    for k in range(3):
        mk = float(M_BWD[k, 1])
        if mk == 0.0:
            continue  # pure passthrough, as in the kernel
        xk = planes[:, k].to(torch.float32)
        out[:, k] = torch.round(torch.clamp(xk + mk * du, 0.0, 255.0)).to(torch.uint8)
    return out


def fused_dct_qim_mark(planes: torch.Tensor, wm2d: torch.Tensor, alpha: float = 20.0,
                       means: torch.Tensor | None = None) -> torch.Tensor:
    """u8 planes [B, 3, H, W] (any strides, H, W % 8 == 0) + bits [H/8, W/8]
    -> new marked planes with the input's strides.  ``means`` [B] defaults to
    ``y_dc_mean(planes)``."""
    _check_planes(planes, "fused_dct_qim_mark")
    b, _, h, w = planes.shape
    nbh, nbw = h // 8, w // 8
    if wm2d.shape != (nbh, nbw):
        raise ValueError(f"fused_dct_qim_mark: want bits [{nbh}, {nbw}], got {tuple(wm2d.shape)}")
    if means is None:
        means = y_dc_mean(planes)
    _check_means(planes, means, "fused_dct_qim_mark")
    if not planes.is_cuda:
        return fused_dct_qim_mark_reference(planes, wm2d, alpha, means)
    if wm2d.device != planes.device or wm2d.dtype != torch.float32 or not wm2d.is_contiguous():
        raise ValueError("fused_dct_qim_mark: bits must be contiguous float32 on the planes' "
                         "device")
    out = torch.empty_like(planes)
    # host arrays the launcher reads: held in locals for the call's duration
    xs, os_ = _strides_host(planes), _strides_host(out)
    _build.launch("vfp_fused_dct_qim_mark", planes.device, planes.data_ptr(), xs.ctypes.data,
                  out.data_ptr(), os_.ctypes.data, wm2d.data_ptr(), means.data_ptr(), b, nbh,
                  nbw, float(alpha), _params_host().ctypes.data)
    fused_dct_qim_mark.launches += 1
    return out


fused_dct_qim_mark.launches = 0


# -- fused_dct_qim_extract --------------------------------------------------------

def fused_dct_qim_extract_reference(planes: torch.Tensor, alpha: float = 20.0) -> torch.Tensor:
    v, step = _qim_inputs(planes, y_dc_mean_reference(planes), alpha)
    # floor-mod, as jnp.mod: round(v / step) = -3 has parity 1
    return (torch.remainder(torch.round(v / step), 2.0) == 1.0).to(torch.float32)


def fused_dct_qim_extract(planes: torch.Tensor, alpha: float = 20.0) -> torch.Tensor:
    """u8 planes [B, 3, H, W] (any strides, H, W % 8 == 0) -> decoded bits
    [B, H/8, W/8] (f32 0/1), each frame's Y mean, equal to
    ``y_dc_mean(planes)``, taken in the same read of the frame."""
    _check_planes(planes, "fused_dct_qim_extract")
    if not planes.is_cuda:
        return fused_dct_qim_extract_reference(planes, alpha)
    b, _, h, w = planes.shape
    nbh, nbw = h // 8, w // 8
    dev = planes.device
    # pass 1's outputs, pass 2's inputs: v, tex, dc a tile; a Y sum a block
    tiles = torch.empty((3, b, nbh * nbw), dtype=torch.float32, device=dev)
    parts = -(-nbh * nbw // EXTRACT_BLOCK)
    partial = torch.empty((b, parts), dtype=torch.int64, device=dev)
    xs = _strides_host(planes)
    _build.launch("vfp_fused_dct_qim_extract", dev, planes.data_ptr(), xs.ctypes.data,
                  tiles.data_ptr(), partial.data_ptr(), b, nbh, nbw, _params_host().ctypes.data)
    fused_dct_qim_extract.launches += 1
    bits = torch.empty((b, nbh, nbw), dtype=torch.float32, device=dev)
    _build.launch("vfp_dct_qim_decide", dev, tiles.data_ptr(), partial.data_ptr(), parts,
                  bits.data_ptr(), b, nbh * nbw, float(alpha))
    fused_dct_qim_extract.decide_launches += 1
    return bits


fused_dct_qim_extract.launches = 0
fused_dct_qim_extract.decide_launches = 0
