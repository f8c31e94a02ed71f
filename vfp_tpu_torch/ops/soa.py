"""Structure-of-arrays block layout (port of ``vfp_tpu/ops/soa.py``).

``image [B, H, W] -> [B, 16, N]``: the flattened 4x4 block on axis 1, the
block index N minor, so per-block math is elementwise over N.  Only the
power-method dominant triplet is ported; the Jacobi branch, the Kronecker
DCT and the AoS variants serve no path of the flagship codec.
"""

from __future__ import annotations

import numpy as np
import torch

_EPS = 1e-20

# Deterministic non-symmetric start vector (never exactly orthogonal to the
# dominant eigenvector of typical DC-dominated blocks); built as the JAX
# package builds it, so both hold the same float32 bits.
_V0 = np.array([1.0, 0.93, 1.08, 1.02], dtype=np.float32)
_V0 /= np.linalg.norm(_V0)


def image_to_soa(img: torch.Tensor, blk: int = 4) -> torch.Tensor:
    """[B, H, W] (H, W multiples of blk) -> contiguous [B, blk*blk, N], blocks row-major."""
    b, h, w = img.shape
    nbh, nbw = h // blk, w // blk
    x = img.reshape(b, nbh, blk, nbw, blk).permute(0, 2, 4, 1, 3)  # [B, blk, blk, nbh, nbw]
    return x.reshape(b, blk * blk, nbh * nbw).contiguous()


def soa_to_image(x: torch.Tensor, h: int, w: int, blk: int = 4) -> torch.Tensor:
    """Inverse of :func:`image_to_soa`."""
    b = x.shape[0]
    nbh, nbw = h // blk, w // blk
    y = x.reshape(b, blk, blk, nbh, nbw).permute(0, 3, 1, 4, 2)  # [B, nbh, blk, nbw, blk]
    return y.reshape(b, h, w)


def top_triplet_soa(m: torch.Tensor, iters: int | None = None):
    """Dominant triplet of each 4x4 block in SoA layout, by repeated squaring.

    m: [B, 16, N] (entry r*4+c of block n).  Returns (s0 [B, N], u [B, 4, N],
    v [B, 4, N]) with B v = s0 u per block.  ``iters or 5`` squarings of
    G = BᵀB, each after a Frobenius renormalisation, then one power step
    from ``_V0``; the same guards as the JAX function.
    """
    b, sq, n = m.shape
    k = int(round(sq ** 0.5))
    x = m.reshape(b, k, k, n)  # [B, r, c, N]
    g = torch.einsum("bran,brdn->badn", x, x)  # G = BᵀB
    v0 = torch.as_tensor(_V0[:k], device=m.device)
    for _ in range(iters or 5):
        norm = torch.sqrt(torch.sum(g * g, dim=(1, 2), keepdim=True))
        g = g / torch.clamp(norm, min=_EPS)
        g = torch.einsum("bikn,bkjn->bijn", g, g)
    v = torch.einsum("bijn,j->bin", g, v0)
    vn = torch.sqrt(torch.sum(v * v, dim=1, keepdim=True))
    vtop = torch.where(vn > _EPS, v / torch.clamp(vn, min=_EPS), v0[None, :, None])
    bv = torch.einsum("bran,ban->brn", x, vtop)
    s0 = torch.sqrt(torch.sum(bv * bv, dim=1))
    e0 = torch.zeros_like(bv)
    e0[:, 0] = 1.0
    u = torch.where(s0[:, None] > _EPS, bv / torch.clamp(s0[:, None], min=_EPS), e0)
    return s0, u, vtop


def rank1_update_soa(m: torch.Tensor, ds: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """m + ds * u vᵀ in SoA layout: m [B,16,N], ds [B,N], u/v [B,4,N]."""
    b, sq, n = m.shape
    outer = u[:, :, None, :] * v[:, None, :, :]  # [B, r, c, N]
    return m + (ds[:, None] * outer.reshape(b, sq, n))
