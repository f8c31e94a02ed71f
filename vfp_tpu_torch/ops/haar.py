"""Single-level orthonormal 2-D Haar DWT (port of ``vfp_tpu/ops/haar.py``).

For a 2x2 tile [[a, b], [c, d]]: LL = (a+b+c+d)/2, LH = (a-b+c-d)/2,
HL = (a+b-c-d)/2, HH = (a-b-c+d)/2; the inverse is the same butterfly
scaled by 1/2.  Batched over leading axes.
"""

from __future__ import annotations

import torch


def haar_dwt2(x: torch.Tensor):
    """[..., H, W] (H, W even) -> (LL, LH, HL, HH), each [..., H/2, W/2]."""
    a = x[..., 0::2, 0::2]
    b = x[..., 0::2, 1::2]
    c = x[..., 1::2, 0::2]
    d = x[..., 1::2, 1::2]
    ll = (a + b + c + d) * 0.5
    lh = (a - b + c - d) * 0.5
    hl = (a + b - c - d) * 0.5
    hh = (a - b - c + d) * 0.5
    return ll, lh, hl, hh


def haar_idwt2(ll, lh, hl, hh) -> torch.Tensor:
    """Inverse of :func:`haar_dwt2`; returns [..., H, W]."""
    a = (ll + lh + hl + hh) * 0.5
    b = (ll - lh + hl - hh) * 0.5
    c = (ll + lh - hl - hh) * 0.5
    d = (ll - lh - hl + hh) * 0.5
    *lead, h2, w2 = ll.shape
    # [..., h2, 2(row), w2, 2(col)] -> interleave
    out = torch.stack([torch.stack([a, b], dim=-1), torch.stack([c, d], dim=-1)], dim=-3)
    return out.reshape(*lead, h2 * 2, w2 * 2)
