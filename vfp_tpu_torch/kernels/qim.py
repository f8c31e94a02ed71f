"""QIM block kernels on SoA blocks ``[B, 16, N]`` (CUDA: ``csrc/qim.cu``).

Replaces the Pallas kernels of ``vfp_tpu/kernels/qim.py``: ``qim_triplet_soa``,
``qim_decode_soa`` and ``qim_embed_soa``, one ``_triplet_core`` and three
epilogues.  Bound on the card: memory (64 B of block read per 4x4 block
against a few hundred register FLOPs); one thread per block index keeps every
intermediate in registers and reads SoA rows coalesced.

Each wrapper takes its plain PyTorch version (``*_reference``) for a tensor on
the CPU and launches the CUDA kernel for a CUDA tensor; there is no fallback
between the two.  ``<wrapper>.launches`` counts kernel launches.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.soa import _EPS, _V0
from . import _build

_V0_HOST = np.ascontiguousarray(_V0, dtype=np.float32)


def _inv_sqrt(x: torch.Tensor) -> torch.Tensor:
    # 1/sqrt with IEEE ops on every device (torch.rsqrt is approximate on CUDA)
    return torch.reciprocal(torch.sqrt(x))


def _triplet_core(rows):
    """Dominant triplet of 16 same-shape tensors rows[r*4+c] (one entry of
    every block each): the plain version of ``csrc/triplet.cuh`` and of
    ``vfp_tpu/kernels/qim.py:_triplet_core``, op for op.  Returns
    (s0, u[4], v[4]) as tensors of the rows' shape."""
    g = [None] * 16
    for a in range(4):
        for b in range(4):
            acc = rows[0 * 4 + a] * rows[0 * 4 + b]
            for r in range(1, 4):
                acc = acc + rows[r * 4 + a] * rows[r * 4 + b]
            g[a * 4 + b] = acc

    # one Frobenius normalisation, then 4 squarings renormalised by the trace
    fro = g[0] * g[0]
    for i in range(1, 16):
        fro = fro + g[i] * g[i]
    inv = _inv_sqrt(torch.clamp(fro, min=_EPS))
    g = [gi * inv for gi in g]
    for _ in range(4):
        g2 = [None] * 16
        for i in range(4):
            for j in range(4):
                acc = g[i * 4 + 0] * g[0 * 4 + j]
                for k in range(1, 4):
                    acc = acc + g[i * 4 + k] * g[k * 4 + j]
                g2[i * 4 + j] = acc
        tr = g2[0] + g2[5] + g2[10] + g2[15]
        inv = torch.reciprocal(torch.clamp(tr, min=_EPS))
        g = [gi * inv for gi in g2]

    # v = normalize(G @ v0)
    v0 = [float(x) for x in _V0]
    v = [None] * 4
    for i in range(4):
        acc = g[i * 4 + 0] * v0[0]
        for j in range(1, 4):
            acc = acc + g[i * 4 + j] * v0[j]
        v[i] = acc
    vn = v[0] * v[0] + v[1] * v[1] + v[2] * v[2] + v[3] * v[3]
    bad = vn <= _EPS
    inv = _inv_sqrt(torch.clamp(vn, min=_EPS))
    v = [torch.where(bad, torch.full_like(vi, v0[i]), vi * inv) for i, vi in enumerate(v)]

    # bv = M v ; s0 = ||bv|| ; u = bv / s0
    bv = [None] * 4
    for r in range(4):
        acc = rows[r * 4 + 0] * v[0]
        for c in range(1, 4):
            acc = acc + rows[r * 4 + c] * v[c]
        bv[r] = acc
    s0sq = bv[0] * bv[0] + bv[1] * bv[1] + bv[2] * bv[2] + bv[3] * bv[3]
    s0 = torch.sqrt(s0sq)
    zero = s0 <= _EPS
    inv = _inv_sqrt(torch.clamp(s0sq, min=_EPS))
    u = [torch.where(zero, torch.full_like(bv[r], 1.0 if r == 0 else 0.0), bv[r] * inv)
         for r in range(4)]
    return s0, u, v


def qim_target(s0: torch.Tensor, bits, scale: float) -> torch.Tensor:
    """QIM embed target s0' = (floor(s0 / scale) + 0.25 + 0.5 * bit) * scale."""
    # divide by a tensor: on CUDA, PyTorch divides by a Python scalar as a
    # multiply by its reciprocal, which can move s0 / scale across an integer
    q = torch.floor(s0 / torch.full_like(s0, scale))
    return (q + 0.25 + 0.5 * bits) * scale


def qim_bit(s0: torch.Tensor, scale: float) -> torch.Tensor:
    """QIM decode: (s0 mod scale) > scale / 2, as f32 0/1 (s0 >= 0, so the
    exact fmod is the mod)."""
    return (torch.fmod(s0, scale) > scale * 0.5).to(torch.float32)


def _rows(m: torch.Tensor):
    return [m[:, i] for i in range(16)]


def _check_soa(m: torch.Tensor, name: str) -> None:
    if m.dtype != torch.float32 or m.dim() != 3 or m.shape[1] != 16:
        raise ValueError(f"{name}: want float32 [B, 16, N] blocks, got {m.dtype} {tuple(m.shape)}")
    if m.is_cuda and not m.is_contiguous():
        raise ValueError(f"{name}: the CUDA kernel takes contiguous [B, 16, N] blocks")


# -- qim_triplet_soa ----------------------------------------------------------

def qim_triplet_soa_reference(m: torch.Tensor):
    s0, u, v = _triplet_core(_rows(m))
    return s0, torch.stack(u, 1), torch.stack(v, 1)


def qim_triplet_soa(m: torch.Tensor):
    """[B, 16, N] spatial SoA blocks -> (s0 [B, N], u [B, 4, N], v [B, 4, N])."""
    _check_soa(m, "qim_triplet_soa")
    if not m.is_cuda:
        return qim_triplet_soa_reference(m)
    b, _, n = m.shape
    out = torch.empty((b, 9, n), dtype=torch.float32, device=m.device)
    with torch.cuda.device(m.device):
        _build.launch("vfp_qim_triplet_soa", m.data_ptr(), out.data_ptr(), b, n,
                      _V0_HOST.ctypes.data)
    qim_triplet_soa.launches += 1
    return out[:, 0], out[:, 1:5], out[:, 5:9]


qim_triplet_soa.launches = 0


# -- qim_decode_soa -----------------------------------------------------------

def qim_decode_soa_reference(m: torch.Tensor, scale: float) -> torch.Tensor:
    s0, _, _ = _triplet_core(_rows(m))
    return qim_bit(s0, scale)


def qim_decode_soa(m: torch.Tensor, scale: float) -> torch.Tensor:
    """[B, 16, N] spatial SoA blocks -> [B, N] decoded bits (f32 0/1)."""
    _check_soa(m, "qim_decode_soa")
    if not m.is_cuda:
        return qim_decode_soa_reference(m, scale)
    b, _, n = m.shape
    out = torch.empty((b, n), dtype=torch.float32, device=m.device)
    with torch.cuda.device(m.device):
        _build.launch("vfp_qim_decode_soa", m.data_ptr(), out.data_ptr(), b, n, float(scale),
                      _V0_HOST.ctypes.data)
    qim_decode_soa.launches += 1
    return out


qim_decode_soa.launches = 0


# -- qim_embed_soa ------------------------------------------------------------

def qim_embed_soa_reference(m: torch.Tensor, wm: torch.Tensor, scale: float) -> torch.Tensor:
    rows = _rows(m)
    s0, u, v = _triplet_core(rows)
    ds = qim_target(s0, wm.reshape(1, -1).to(torch.float32), scale) - s0
    return torch.stack([rows[r * 4 + c] + ds * (u[r] * v[c])
                        for r in range(4) for c in range(4)], 1)


def qim_embed_soa(m: torch.Tensor, wm: torch.Tensor, scale: float) -> torch.Tensor:
    """[B, 16, N] spatial SoA blocks + [N] bits -> marked SoA blocks (new tensor)."""
    _check_soa(m, "qim_embed_soa")
    if wm.shape != (m.shape[2],):
        raise ValueError(f"qim_embed_soa: want [{m.shape[2]}] bits, got {tuple(wm.shape)}")
    if not m.is_cuda:
        return qim_embed_soa_reference(m, wm, scale)
    if wm.device != m.device or wm.dtype != torch.float32 or not wm.is_contiguous():
        raise ValueError("qim_embed_soa: bits must be contiguous float32 on the blocks' device")
    b, _, n = m.shape
    out = torch.empty_like(m)
    with torch.cuda.device(m.device):
        _build.launch("vfp_qim_embed_soa", m.data_ptr(), wm.data_ptr(), out.data_ptr(), b, n,
                      float(scale), _V0_HOST.ctypes.data)
    qim_embed_soa.launches += 1
    return out


qim_embed_soa.launches = 0
