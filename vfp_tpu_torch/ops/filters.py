"""cv2-compatible filtering helpers of the DT-CWT codecs (port of
``vfp_tpu/ops/filters.py``), and the port's own copies of cv2's float32
``INTER_LINEAR`` and ``INTER_AREA`` resizes, which the watermark generators
and the image degenerator need (the card's machine has no cv2).
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
    """Source indices and float32 fractions of cv2's default INTER_LINEAR
    resize of a float image (its IPP branch) along one axis: the half-pixel
    coordinate ``(d + 0.5) * scale - 0.5`` in double, both taps clipped to
    the image, the fraction never snapped to 0 at the borders."""
    f = (np.arange(dst) + 0.5) * (src / dst) - 0.5
    s = np.floor(f)
    si = s.astype(np.int64)
    return np.clip(si, 0, src - 1), np.clip(si + 1, 0, src - 1), (f - s).astype(np.float32)


def _lerp(a0: np.ndarray, a1: np.ndarray, t: np.ndarray) -> np.ndarray:
    """``fma(a1 - a0, t, a0)`` in float32: the difference rounded to float,
    the product exact in double, one rounding of the sum (two, through
    double, which differ from one only on a float midpoint)."""
    return (a0.astype(np.float64) + (a1 - a0).astype(np.float64) * t).astype(np.float32)


def resize_linear(img: np.ndarray, size) -> np.ndarray:
    """``cv2.resize(img, (w, h))`` of a 2-D float32 image with the default
    INTER_LINEAR, bit for bit where cv2 takes its IPP branch (a source of at
    least 2 rows and 2 columns): a horizontal pass, then a vertical one,
    each an ``fma`` of the neighbours' difference."""
    h, w = size
    img = np.asarray(img, np.float32)
    x0, x1, tx = _linear_taps(w, img.shape[1])
    y0, y1, ty = _linear_taps(h, img.shape[0])
    rows = _lerp(img[:, x0], img[:, x1], tx)
    return _lerp(rows[y0], rows[y1], ty[:, None])


def _area_up_taps(dst: int, src: int):
    """cv2's INTER_AREA taps along an axis when the image grows on some
    axis: ``s = floor(d * scale)``, fraction ``(d + 1) - (s + 1) / scale``
    (as float; 0 where it is not positive, else its part after the point),
    clamped to the first and last sample as cv2 does (the second weight 0
    there).  Returns (s0, s1, w0, w1), the weights float32."""
    inv = dst / src
    scale = 1.0 / inv
    d = np.arange(dst)
    s = np.floor(d * scale).astype(np.int64)
    f = ((d + 1) - (s + 1) * inv).astype(np.float32)
    f = np.where(f <= 0, np.float32(0), f - np.floor(f)).astype(np.float32)
    low, high = s < 0, s >= src - 1
    f[low], s[low] = 0.0, 0
    f[high], s[high] = 0.0, src - 1
    return s, np.minimum(s + 1, src - 1), (np.float32(1.0) - f).astype(np.float32), f


def _area_tab(dst: int, src: int):
    """cv2's ``computeResizeAreaTab`` for a shrinking axis: for each output
    cell, the source samples it covers and their float32 weights (partial
    edge samples weighted by the covered fraction, all over the cell's
    width).  Returns [dst, K] indices and weights, zero-padded."""
    scale = src / dst
    cells = []
    for dx in range(dst):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        width = min(scale, src - fsx1)
        sx2 = min(int(np.floor(fsx2)), src - 1)
        sx1 = min(int(np.ceil(fsx1)), sx2)
        taps = []
        if sx1 - fsx1 > 1e-3:
            taps.append((sx1 - 1, np.float32((sx1 - fsx1) / width)))
        taps += [(sx, np.float32(1.0 / width)) for sx in range(sx1, sx2)]
        if fsx2 - sx2 > 1e-3:
            taps.append((sx2, np.float32(min(min(fsx2 - sx2, 1.0), width) / width)))
        cells.append(taps)
    k = max(len(c) for c in cells)
    idx = np.zeros((dst, k), np.int64)
    wgt = np.zeros((dst, k), np.float32)
    for dx, taps in enumerate(cells):
        for j, (sx, a) in enumerate(taps):
            idx[dx, j], wgt[dx, j] = sx, a
    return idx, wgt


def resize_area(img: np.ndarray, size) -> np.ndarray:
    """``cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)`` of a 2-D
    float32 image.  Shrinking on both axes by whole factors: the mean of
    each block (its sum in row-major order times 1 / area).  Shrinking by
    other factors: area weights, each row's horizontal sums then the
    vertical sum of the rows in order, in float32.  Growing on either axis:
    cv2's two-tap interpolation with area weights."""
    h, w = size
    img = np.asarray(img, np.float32)
    sh, sw = img.shape
    scale_x, scale_y = 1.0 / (w / sw), 1.0 / (h / sh)
    if scale_x < 1 or scale_y < 1:
        sx0, sx1, ax0, ax1 = _area_up_taps(w, sw)
        sy0, sy1, by0, by1 = _area_up_taps(h, sh)
        rows = img[:, sx0] * ax0 + img[:, sx1] * ax1
        return (rows[sy0] * by0[:, None] + rows[sy1] * by1[:, None]).astype(np.float32)
    ix, iy = int(round(scale_x)), int(round(scale_y))
    if abs(scale_x - ix) < np.finfo(np.float64).eps and abs(scale_y - iy) < np.finfo(np.float64).eps:
        blocks = img[: h * iy, : w * ix].reshape(h, iy, w, ix).transpose(0, 2, 1, 3)
        blocks = blocks.reshape(h, w, iy * ix)
        total = np.zeros((h, w), np.float32)
        for k in range(0, iy * ix - 3, 4):  # cv2 adds four samples at a time
            total += ((blocks[..., k] + blocks[..., k + 1]) + blocks[..., k + 2]) + blocks[..., k + 3]
        for k in range(iy * ix // 4 * 4, iy * ix):
            total += blocks[..., k]
        return (total * np.float32(1.0 / (ix * iy))).astype(np.float32)
    xi, xa = _area_tab(w, sw)
    yi, ya = _area_tab(h, sh)
    rows = np.zeros((sh, w), np.float32)
    for j in range(xi.shape[1]):
        rows += img[:, xi[:, j]] * xa[:, j]
    out = np.zeros((h, w), np.float32)
    for j in range(yi.shape[1]):
        out += ya[:, j, None] * rows[yi[:, j]]
    return out
