"""Structure-of-arrays block layout (port of ``vfp_tpu/ops/soa.py``).

``image [B, H, W] -> [B, blk*blk, N]``: the flattened block on axis 1, the
block index N minor, so per-block math is elementwise over N.  Ported: the
layout transforms, the Kronecker DCT of the DctQim codec's torch path, and
the dominant triplet by the power method (the codecs' path) or by cyclic
Jacobi sweeps (``method="jacobi"``); the AoS variants serve no ported path.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .dct import dct_matrix, full_f32
from .svd4 import _jacobi_top_eigvec

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


@lru_cache(maxsize=None)
def dct_kron(n: int) -> np.ndarray:
    """D ⊗ D [n*n, n*n] (float32, built in float64 as the JAX package builds it):
    vec(D A Dᵀ) = (D ⊗ D) vec(A) for row-major vec."""
    d = dct_matrix(n).astype(np.float64)
    return np.kron(d, d).astype(np.float32)


def dct_soa(x: torch.Tensor) -> torch.Tensor:
    """[B, n*n, N] spatial SoA blocks -> DCT coefficients (cv2.dct-compatible per block)."""
    full_f32(x)
    n = int(round(x.shape[1] ** 0.5))
    k = torch.as_tensor(dct_kron(n), device=x.device)
    return torch.einsum("ij,bjn->bin", k, x)


def idct_soa(x: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`dct_soa` (Dᵀ ⊗ Dᵀ, the transpose of the orthonormal map)."""
    full_f32(x)
    n = int(round(x.shape[1] ** 0.5))
    k = torch.as_tensor(dct_kron(n), device=x.device)
    return torch.einsum("ji,bjn->bin", k, x)


def top_triplet_soa(m: torch.Tensor, method: str = "power", iters: int | None = None):
    """Dominant triplet of each 4x4 block in SoA layout.

    m: [B, 16, N] (entry r*4+c of block n).  Returns (s0 [B, N], u [B, 4, N],
    v [B, 4, N]) with B v = s0 u per block.  ``method="power"`` (default):
    ``iters or 5`` squarings of G = BᵀB, each after a Frobenius
    renormalisation, then one power step from ``_V0``.  ``method="jacobi"``:
    ``iters or 5`` cyclic Jacobi sweeps of G scaled by its largest magnitude
    (``ops/svd4.py``'s rotations, the JAX SoA branch's formulas), v the
    eigenvector of the first largest eigenvalue.  The same guards as the JAX
    function.
    """
    b, sq, n = m.shape
    k = int(round(sq ** 0.5))
    x = m.reshape(b, k, k, n)  # [B, r, c, N]
    g = torch.einsum("bran,brdn->badn", x, x)  # G = BᵀB
    if method == "jacobi":
        vtop, _ = _jacobi_top_eigvec(g.permute(0, 3, 1, 2), sweeps=iters or 5)  # [B, N, k]
        vtop = vtop.permute(0, 2, 1)
    elif method == "power":
        v0 = torch.as_tensor(_V0[:k], device=m.device)
        for _ in range(iters or 5):
            norm = torch.sqrt(torch.sum(g * g, dim=(1, 2), keepdim=True))
            g = g / torch.clamp(norm, min=_EPS)
            g = torch.einsum("bikn,bkjn->bijn", g, g)
        v = torch.einsum("bijn,j->bin", g, v0)
        vn = torch.sqrt(torch.sum(v * v, dim=1, keepdim=True))
        vtop = torch.where(vn > _EPS, v / torch.clamp(vn, min=_EPS), v0[None, :, None])
    else:
        raise ValueError(f"unknown triplet method: {method}")
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
