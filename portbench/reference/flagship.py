"""The DWT+DCT+SVD QIM codec (offmark-py's DwtDctSvd encoder and decoder)
on uint8 BGR frames.

Mark: float BGR -> YUV; the U channel, cropped to a multiple of 4, gets a
one-level Haar DWT; every 4x4 block of its LL band has its dominant
singular value s0 moved to (floor(s0 / scale) + 0.25 + 0.5 * bit) * scale
along its own singular vectors; inverse DWT, YUV -> BGR, clip, round half
to even.  The per-block DCT of the published encoder is an orthogonal
similarity and leaves the singular values and the rank-one update
unchanged, so it is left out.  Decode: bit = (s0 mod scale) > scale / 2,
the plane zero-padded to the declared capacity H * W // 64.
"""

import numpy as np
import torch

from . import colour
from .spread import spread_bits


def capacity(h: int, w: int) -> int:
    return h * w // 64


def make_watermark(payload, key: int, h: int, w: int) -> np.ndarray:
    """The payload spread to the capacity (offmark-py's Shuffler)."""
    return spread_bits(payload, key, capacity(h, w))


def _haar(x):
    a, b = x[..., 0::2, 0::2], x[..., 0::2, 1::2]
    c, d = x[..., 1::2, 0::2], x[..., 1::2, 1::2]
    return ((a + b + c + d) * 0.5, (a - b + c - d) * 0.5, (a + b - c - d) * 0.5,
            (a - b - c + d) * 0.5)


def _ihaar(ll, lh, hl, hh):
    a = (ll + lh + hl + hh) * 0.5
    b = (ll - lh + hl - hh) * 0.5
    c = (ll + lh - hl - hh) * 0.5
    d = (ll - lh - hl + hh) * 0.5
    n, h2, w2 = ll.shape
    out = ll.new_empty((n, 2 * h2, 2 * w2))
    out[:, 0::2, 0::2], out[:, 0::2, 1::2] = a, b
    out[:, 1::2, 0::2], out[:, 1::2, 1::2] = c, d
    return out


def _blocks(ll, nbh: int, nbw: int):
    n = ll.shape[0]
    return ll[:, : nbh * 4, : nbw * 4].reshape(n, nbh, 4, nbw, 4).permute(0, 1, 3, 2, 4)


def _svd(blocks, dtype):
    """Singular triplets of each 4x4 block (LAPACK-style SVD in float32; in
    the control its inputs and outputs are rounded to ``dtype``)."""
    u, s, vh = torch.linalg.svd(blocks.to(torch.float32), full_matrices=False)
    return s[..., 0].to(dtype), u[..., :, 0].to(dtype), vh[..., 0, :].to(dtype)


def mark(frames: torch.Tensor, wm: np.ndarray, scale: float = 15.0,
         dtype=torch.float32) -> torch.Tensor:
    """[n, H, W, 3] uint8 + [capacity] 0/1 plane -> marked [n, H, W, 3] uint8."""
    n, h, w, _ = frames.shape
    h4, w4 = h // 4 * 4, w // 4 * 4
    nbh, nbw = h4 // 8, w4 // 8
    x = frames.to(dtype)
    yuv = colour.to_yuv(x)
    u_ch = yuv[..., 1]
    ll, lh, hl, hh = _haar(u_ch[:, :h4, :w4])
    blk = _blocks(ll, nbh, nbw)
    s0, u, v = _svd(blk, dtype)
    bits = torch.as_tensor(np.asarray(wm, np.float32).reshape(-1)[: nbh * nbw],
                           device=frames.device).reshape(nbh, nbw).to(dtype)
    # an IEEE division (a CUDA division by a Python scalar multiplies by its
    # reciprocal, which can move s0 / scale across an integer)
    target = (torch.floor(s0 / torch.full_like(s0, scale)) + 0.25 + 0.5 * bits) * scale
    blk = blk + (target - s0)[..., None, None] * u[..., :, None] * v[..., None, :]
    ll = ll.clone()
    ll[:, : nbh * 4, : nbw * 4] = blk.permute(0, 1, 3, 2, 4).reshape(n, nbh * 4, nbw * 4)
    yuv = yuv.clone()
    yuv[:, :h4, :w4, 1] = _ihaar(ll, lh, hl, hh)
    return colour.to_u8(colour.to_bgr(yuv))


def decode(frames: torch.Tensor, scale: float = 15.0, dtype=torch.float32) -> torch.Tensor:
    """[n, H, W, 3] uint8 -> [n, capacity] float32 0/1 bit planes."""
    n, h, w, _ = frames.shape
    h4, w4 = h // 4 * 4, w // 4 * 4
    nbh, nbw = h4 // 8, w4 // 8
    u_ch = colour.channel(frames.to(dtype), 1)
    ll = _haar(u_ch[:, :h4, :w4])[0]
    s0 = _svd(_blocks(ll, nbh, nbw), dtype)[0]
    bits = (torch.fmod(s0, scale) > scale * 0.5).to(torch.float32).reshape(n, nbh * nbw)
    return torch.nn.functional.pad(bits, (0, capacity(h, w) - nbh * nbw))
