"""cv2-compatible filtering helpers of the DT-CWT codecs (port of
``vfp_tpu/ops/filters.py``), and the port's own copy of cv2's float32
``INTER_LINEAR`` resize, which the watermark generator needs (the card's
machine has no cv2).
"""

from __future__ import annotations

import numpy as np
import torch


def filter2d_mean2x2(x: torch.Tensor) -> torch.Tensor:
    """cv2.filter2D(x, -1, [[1/4, 1/4], [1/4, 1/4]]), batched [..., H, W].

    cv2 anchors an even kernel at (1, 1) with BORDER_REFLECT_101, so
    out[i, j] = mean of x[i-1:i+1, j-1:j+1] with row -1 read as row 1 and
    column -1 as column 1."""
    xp = torch.cat([x[..., 1:2, :], x], dim=-2)
    xp = torch.cat([xp[..., :, 1:2], xp], dim=-1)
    return 0.25 * (((xp[..., :-1, :-1] + xp[..., :-1, 1:]) + xp[..., 1:, :-1]) + xp[..., 1:, 1:])


def rebin_mean(a: torch.Tensor, shape) -> torch.Tensor:
    """Mean-pool [..., H, W] onto ``shape``, zero-padding an odd H first."""
    h, w = a.shape[-2], a.shape[-1]
    if h % 2 == 1:
        a = torch.cat([a, a.new_zeros((*a.shape[:-2], 1, w))], dim=-2)
        h += 1
    th, tw = shape
    a = a.reshape(*a.shape[:-2], th, h // th, tw, w // tw)
    return a.mean(dim=(-3, -1))


def _linear_taps(dst: int, src: int):
    """cv2's INTER_LINEAR source indices and float32 weights along one axis:
    the half-pixel source coordinate ``(d + 0.5) * scale - 0.5`` and its
    fraction in double, the weights stored as float, clamped to the first
    and last source sample."""
    scale = 1.0 / (dst / src)
    f = (np.arange(dst) + 0.5) * scale - 0.5
    s = np.floor(f).astype(np.int64)
    f = f - s
    low, high = s < 0, s >= src - 1
    f[low], s[low] = 0.0, 0
    f[high], s[high] = 0.0, src - 1
    f32 = f.astype(np.float32)
    return s, np.minimum(s + 1, src - 1), (np.float32(1.0) - f32).astype(np.float32), f32


def resize_linear(img: np.ndarray, size) -> np.ndarray:
    """``cv2.resize(img, (w, h))`` of a 2-D float32 image with the default
    INTER_LINEAR: a horizontal pass, then a vertical one, in float32."""
    h, w = size
    img = np.asarray(img, np.float32)
    sx0, sx1, ax0, ax1 = _linear_taps(w, img.shape[1])
    sy0, sy1, by0, by1 = _linear_taps(h, img.shape[0])
    rows = img[:, sx0] * ax0 + img[:, sx1] * ax1
    return (rows[sy0] * by0[:, None] + rows[sy1] * by1[:, None]).astype(np.float32)
