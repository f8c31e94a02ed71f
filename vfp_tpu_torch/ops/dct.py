"""Orthonormal 2-D DCT-II on NxN blocks as two small matrix products (port of
``vfp_tpu/ops/dct.py``).

``cv2.dct(A) == D @ A @ D.T`` with the orthonormal DCT-II matrix D.  The
matrix is built in float64 and cast to float32, as the JAX package builds
it, so both hold the same bits.  On CUDA the products need TF32 off
(``torch.backends.cuda.matmul.allow_tf32 = False``, PyTorch's default):
QIM bins are sensitive to matmul precision, so ``full_f32`` raises where
it is on.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=None)
def dct_matrix(n: int) -> np.ndarray:
    """Orthonormal DCT-II matrix D (f32), rows = frequencies."""
    k = np.arange(n, dtype=np.float64)[:, None]
    i = np.arange(n, dtype=np.float64)[None, :]
    d = np.sqrt(2.0 / n) * np.cos(np.pi * (2 * i + 1) * k / (2 * n))
    d[0] *= 1.0 / np.sqrt(2.0)
    return d.astype(np.float32)


def full_f32(x: torch.Tensor) -> None:
    """Raise if a float32 matrix product on ``x``'s device would run in TF32."""
    if x.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the DCT products need full float32 matmuls: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")


def dct2(blocks: torch.Tensor) -> torch.Tensor:
    """[..., N, N] spatial blocks -> DCT-II coefficients (cv2.dct-compatible)."""
    full_f32(blocks)
    d = torch.as_tensor(dct_matrix(blocks.shape[-1]), device=blocks.device)
    return torch.einsum("ij,...jk,lk->...il", d, blocks, d)


def idct2(coeffs: torch.Tensor) -> torch.Tensor:
    """[..., N, N] DCT-II coefficients -> spatial blocks (cv2.idct-compatible)."""
    full_f32(coeffs)
    d = torch.as_tensor(dct_matrix(coeffs.shape[-1]), device=coeffs.device)
    return torch.einsum("ji,...jk,kl->...il", d, coeffs, d)
