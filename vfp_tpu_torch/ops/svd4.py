"""Batched dominant singular triplet of tiny (4x4) matrices (port of
``vfp_tpu/ops/svd4.py``).

The codecs only use the dominant triplet (s0, u0, v0) of a block B: the mark
rewrites s0 as the rank-1 update ``B + (s0' - s0) u0 v0^T`` and the decode
reads ``s0 % scale``.  Two batched methods over G = B^T B, both free of
data-dependent control flow:

* ``jacobi`` (default): cyclic Jacobi eigensolver, a fixed number of sweeps
  of 6 Givens rotations; accurate for every spectrum, near-tied ones too.
* ``power``: power iteration by repeated squaring, m normalised squarings
  giving 2^m power steps; its error decays like (lambda2/lambda1)^(2^m).

Every product is an elementwise multiply and a sum in float32, never a
matmul, so TF32 cannot enter whatever the process's matmul settings.

Degenerate cases: a zero block has s0 = 0 and u/v fall back to unit basis
vectors (``B + ds u v^T`` then has top singular value ds); with tied top
singular values any unit vector of the dominant eigenspace is a valid v0.
"""

from __future__ import annotations

import numpy as np
import torch

# Deterministic start vector, deliberately non-symmetric so it is never exactly
# orthogonal to the dominant eigenvector of typical (e.g. DC-dominated) blocks.
_V0 = np.array([1.0, 0.93, 1.08, 1.02], dtype=np.float32)
_V0 /= np.linalg.norm(_V0)

_EPS = 1e-20


def _gram(b: torch.Tensor) -> torch.Tensor:
    """B^T B of [..., n, n]: G[i, k] = sum_j B[j, i] B[j, k]."""
    return (b[..., :, :, None] * b[..., :, None, :]).sum(dim=-3)


def _matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A B of [..., n, n] matrices: C[i, k] = sum_j A[i, j] B[j, k]."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(dim=-2)


def _matvec(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """A v of [..., n, n] and [..., n] (or [n])."""
    return (a * v[..., None, :]).sum(dim=-1)


# -- Jacobi eigensolver (default) ------------------------------------------------------

def _jacobi_rotate(g, v, p, q):
    """One batched Givens rotation zeroing G[..., p, q] (and [q, p])."""
    apq = g[..., p, q]
    app = g[..., p, p]
    aqq = g[..., q, q]
    # t = sign(tau) / (|tau| + sqrt(1 + tau^2)); <= so that apq == 0 is
    # always "converged" (an all-zero row flushes the threshold to zero)
    small = apq.abs() <= 1e-12 * (app.abs() + aqq.abs())
    tau = (aqq - app) / (2.0 * torch.where(small, torch.ones_like(apq), apq))
    t = torch.sign(tau) / (tau.abs() + torch.sqrt(1.0 + tau * tau))
    t = torch.where(small, torch.zeros_like(t), t)
    c = 1.0 / torch.sqrt(1.0 + t * t)
    s = t * c
    c_, s_ = c[..., None], s[..., None]
    g = g.clone()
    gp = c_ * g[..., p, :] - s_ * g[..., q, :]  # rows
    gq = s_ * g[..., p, :] + c_ * g[..., q, :]
    g[..., p, :], g[..., q, :] = gp, gq
    gp = c_ * g[..., :, p] - s_ * g[..., :, q]  # columns
    gq = s_ * g[..., :, p] + c_ * g[..., :, q]
    g[..., :, p], g[..., :, q] = gp, gq
    v = v.clone()  # accumulate the eigenvectors (columns of v)
    vp = c_ * v[..., :, p] - s_ * v[..., :, q]
    vq = s_ * v[..., :, p] + c_ * v[..., :, q]
    v[..., :, p], v[..., :, q] = vp, vq
    return g, v


def _jacobi_top_eigvec(g: torch.Tensor, sweeps: int):
    """Dominant (eigenvector, eigenvalue) of symmetric [..., n, n] via Jacobi."""
    n = g.shape[-1]
    # normalise magnitudes once for float32 health
    scale = torch.clamp(g.abs().amax(dim=(-2, -1), keepdim=True), min=_EPS)
    gn = g / scale
    v = torch.eye(n, dtype=g.dtype, device=g.device).expand(g.shape)
    for _ in range(sweeps):
        for p in range(n):
            for q in range(p + 1, n):
                gn, v = _jacobi_rotate(gn, v, p, q)
    eig = torch.diagonal(gn, dim1=-2, dim2=-1)  # [..., n]
    k = torch.argmax(eig, dim=-1)  # the first of tied maxima, as jnp.argmax
    vtop = torch.gather(v, -1, k[..., None, None].expand(*k.shape, n, 1))[..., 0]
    lam = torch.gather(eig, -1, k[..., None])[..., 0] * scale[..., 0, 0]
    return vtop, torch.clamp(lam, min=0.0)


# -- power iteration by repeated squaring ----------------------------------------------

def _power_top_eigvec(g: torch.Tensor, n_squarings: int) -> torch.Tensor:
    for _ in range(n_squarings):
        norm = torch.sqrt((g * g).sum(dim=(-2, -1), keepdim=True))
        g = g / torch.clamp(norm, min=_EPS)
        g = _matmul(g, g)
    v0 = torch.as_tensor(_V0[: g.shape[-1]], device=g.device)
    v = _matvec(g, v0)
    vnorm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return torch.where(vnorm > _EPS, v / torch.clamp(vnorm, min=_EPS), v0)


# -- public API -------------------------------------------------------------------------

def _top_v(b: torch.Tensor, method: str, iters: int | None) -> torch.Tensor:
    g = _gram(b)
    if method == "jacobi":
        v, _ = _jacobi_top_eigvec(g, sweeps=iters or 5)
    elif method == "power":
        v = _power_top_eigvec(g, n_squarings=iters or 6)
    else:
        raise ValueError(f"unknown svd method: {method}")
    return v


def top_singular_triplet(b: torch.Tensor, method: str = "jacobi", iters: int | None = None):
    """[..., n, n] float32 -> (s0 [...], u0 [..., n], v0 [..., n]) with B v0 = s0 u0."""
    v = _top_v(b, method, iters)
    bv = _matvec(b, v)
    s0 = torch.linalg.vector_norm(bv, dim=-1)
    e0 = torch.zeros_like(v)
    e0[..., 0] = 1.0
    u = torch.where(s0[..., None] > _EPS, bv / torch.clamp(s0[..., None], min=_EPS), e0)
    return s0, u, v


def top_singular_value(b: torch.Tensor, method: str = "jacobi",
                       iters: int | None = None) -> torch.Tensor:
    """[..., n, n] float32 -> dominant singular value s0 [...]."""
    return torch.linalg.vector_norm(_matvec(b, _top_v(b, method, iters)), dim=-1)
