"""The DT-CWT keyed presence codec (offmark-py's dtcwt_key_encoder) on
uint8 BGR frames, marking direction.

A 2-D dual-tree complex wavelet transform with circular extension: level 1
the LeGall pair, tree b sampled one sample later; levels 2 and 3 the
q-shift pair.  Each level's four row/column tree mixes (aa, ab, ba, bb)
give six complex subbands [LH+, LH-, HL+, HL-, HH+, HH-]:
z+ = ((aa - bb) + i (ab + ba)) / 2, z- = ((aa + bb) + i (ab - ba)) / 2.

Mark: masks from the luminance: |level-2 subbands|, cv2's 2x2 mean filter
(anchor (1, 1), reflect-101 border), mean-pooled onto the level-3 grid,
``ceil(m / step)``.  The watermark plane's level-1 subbands are written
into the four corners of each level-3 subband plane (later corners win
where they overlap) and added to the U channel's level-3 subbands scaled
by ``alpha * mask``.  The transform is linear and only those subbands
change, so the U channel's change is the inverse transform of the added
coefficients alone, and the marked frame is
``round(clip(x + dU * M_BWD[:, 1], 0, 255))``.  Real arithmetic only, so
that the precision control can run it in bfloat16.
"""

import numpy as np
import torch

from . import colour
from .spread import key_plane
from . import dtcwt_filters as F

_TREES = ((0, 0), (0, 1), (1, 0), (1, 1))  # (row tree, column tree), 0 = a


def _f(a):
    return [float(c) for c in a]


def _qshift(tree: int):
    if tree == 0:
        return _f(F.QSHIFT_H0A), _f(F.QSHIFT_H1A), _f(F.QSHIFT_G0A), _f(F.QSHIFT_G1A), F.QSHIFT_ROLL_A
    return _f(F.QSHIFT_H0B), _f(F.QSHIFT_H1B), _f(F.QSHIFT_G0B), _f(F.QSHIFT_G1B), F.QSHIFT_ROLL_B


def down2(x, f, phase: int, dim: int):
    """y[m] = sum_k f[k] x[(2m + phase - k) mod N] along ``dim``."""
    n = x.shape[dim]
    idx = torch.arange(0, n, 2, device=x.device)
    acc = None
    for k, c in enumerate(f):
        t = c * torch.index_select(x, dim, (idx + phase - k) % n)
        acc = t if acc is None else acc + t
    return acc


def up2(y, f, phase: int, dim: int):
    """x[n] = sum_k f[k] y2[(n - k) mod N], y2 zero but y2[phase::2] = y."""
    n = 2 * y.shape[dim]
    shape = list(y.shape)
    shape[dim] = n
    y2 = y.new_zeros(shape)
    y2.index_copy_(dim, torch.arange(phase, n, 2, device=y.device), y)
    acc = None
    for k, c in enumerate(f):
        t = c * torch.roll(y2, k, dim)
        acc = t if acc is None else acc + t
    return acc


def _analysis(x, h0r, h1r, h0c, h1c, row_phase, col_phase, lowpass_only=False):
    lo = down2(x, h0r, row_phase, -2)
    ll = down2(lo, h0c, col_phase, -1)
    if lowpass_only:
        return ll, None
    hi = down2(x, h1r, row_phase, -2)
    return ll, (down2(lo, h1c, col_phase, -1), down2(hi, h0c, col_phase, -1),
                down2(hi, h1c, col_phase, -1))


def _synthesis(ll, subs, g0r, g1r, g0c, g1c, row_phase, col_phase):
    """One tree of one synthesis level, before its roll; ``subs`` may be None
    (zero highpasses)."""
    lo = up2(ll, g0c, col_phase, -1)
    hi = None
    if subs is not None:
        lh, hl, hh = subs
        lo = lo + up2(lh, g1c, col_phase, -1)
        hi = up2(hl, g0c, col_phase, -1) + up2(hh, g1c, col_phase, -1)
    x = up2(lo, g0r, row_phase, -2)
    if hi is not None:
        x = x + up2(hi, g1r, row_phase, -2)
    return x


def level1(x, lowpass_only=False):
    """[..., H, W] (even) -> four tree lowpasses [..., 4, H/2, W/2] and, unless
    ``lowpass_only``, their (lh, hl, hh) per tree."""
    h0, h1 = _f(F.LEGALL_H0), _f(F.LEGALL_H1)
    lls, subs = [], []
    for rt, ct in _TREES:
        ll, s = _analysis(x, h0, h1, h0, h1, rt, ct, lowpass_only)
        lls.append(ll)
        subs.append(s)
    return torch.stack(lls, dim=-3), subs


def qshift_level(ll4, lowpass_only=False):
    """[..., 4, h, w] tree lowpasses (even h, w) -> the next level's."""
    lls, subs = [], []
    for ci, (rt, ct) in enumerate(_TREES):
        h0r, h1r = _qshift(rt)[:2]
        h0c, h1c = _qshift(ct)[:2]
        ll, s = _analysis(ll4[..., ci, :, :], h0r, h1r, h0c, h1c, 0, 0, lowpass_only)
        lls.append(ll)
        subs.append(s)
    return torch.stack(lls, dim=-3), subs


def magnitudes(subs):
    """Per-tree (lh, hl, hh) -> |subband| [..., 6, h, w], [LH+, LH-, HL+, HL-, HH+, HH-]."""
    out = []
    for band in range(3):
        aa, ab, ba, bb = (subs[t][band] for t in range(4))
        out.append(0.5 * torch.sqrt((aa - bb) ** 2 + (ab + ba) ** 2))
        out.append(0.5 * torch.sqrt((aa + bb) ** 2 + (ab - ba) ** 2))
    return torch.stack(out, dim=-3)


def complex_parts(subs):
    """Per-tree (lh, hl, hh) -> (real, imag), each [..., 6, h, w]."""
    re, im = [], []
    for band in range(3):
        aa, ab, ba, bb = (subs[t][band] for t in range(4))
        re += [(aa - bb) * 0.5, (aa + bb) * 0.5]
        im += [(ab + ba) * 0.5, (ab - ba) * 0.5]
    return torch.stack(re, dim=-3), torch.stack(im, dim=-3)


def tree_parts(re, im):
    """Inverse of ``complex_parts``: [..., 6, h, w] -> per-tree (lh, hl, hh)."""
    trees = [[None] * 3 for _ in range(4)]
    for band in range(3):
        pr, pi = re[..., 2 * band, :, :], im[..., 2 * band, :, :]
        mr, mi = re[..., 2 * band + 1, :, :], im[..., 2 * band + 1, :, :]
        trees[0][band] = pr + mr  # aa
        trees[1][band] = pi + mi  # ab
        trees[2][band] = pi - mi  # ba
        trees[3][band] = mr - pr  # bb
    return [tuple(t) for t in trees]


def mean2x2(x):
    """cv2.filter2D with the 2x2 box of 1/4: anchor (1, 1), BORDER_REFLECT_101."""
    xp = torch.cat([x[..., 1:2, :], x], dim=-2)
    xp = torch.cat([xp[..., :, 1:2], xp], dim=-1)
    return 0.25 * (((xp[..., :-1, :-1] + xp[..., :-1, 1:]) + xp[..., 1:, :-1]) + xp[..., 1:, 1:])


def pool_to(a, shape):
    """Mean-pool [..., H, W] onto ``shape``, an odd H zero-padded first."""
    h, w = a.shape[-2], a.shape[-1]
    if h % 2:
        a = torch.cat([a, a.new_zeros((*a.shape[:-2], 1, w))], dim=-2)
        h += 1
    th, tw = shape
    return a.reshape(*a.shape[:-2], th, h // th, tw, w // tw).mean(dim=(-3, -1))


def corners(c, shape):
    """[..., h, w] into the four corners of a [..., H, W] zero plane, in the
    order top-left, bottom-left, top-right, bottom-right."""
    h, w = c.shape[-2], c.shape[-1]
    out = c.new_zeros((*c.shape[:-2], *shape))
    out[..., :h, :w] = c
    out[..., -h:, :w] = c
    out[..., :h, -w:] = c
    out[..., -h:, -w:] = c
    return out


def plane_size(h: int, w: int):
    """The watermark plane's sides: the level-3 grid rounded up to even."""
    hh = (((h + 1) // 2 + 1) // 2 + 1) // 2
    ww = (((w + 1) // 2 + 1) // 2 + 1) // 2
    return hh + hh % 2, ww + ww % 2


def make_watermark(payload, key: int, h: int, w: int) -> np.ndarray:
    """The keyed +-1 plane at the plane size; a presence mark carries no payload."""
    return key_plane(key, plane_size(h, w))


def wm_spectrum(plane: torch.Tensor, dtype=torch.float32):
    """Level-1 subbands of the watermark plane [h, w] -> (re, im) [6, h/2, w/2]."""
    _, subs = level1(plane.to(dtype))
    return complex_parts(subs)


def mark(frames: torch.Tensor, wm_plane: torch.Tensor, alpha: float = 10.0,
         step: float = 5.0, dtype=torch.float32) -> torch.Tensor:
    """[n, H, W, 3] uint8 (H, W multiples of 8) + watermark plane (the
    level-3 grid [H/8, W/8] rounded up to even sides) -> marked [n, H, W, 3]
    uint8."""
    n, h, w, _ = frames.shape
    if h % 8 or w % 8:
        raise ValueError(f"the reference takes frames whose sides are multiples of 8, "
                         f"not {h}x{w}")
    x = frames.to(dtype)
    y = colour.channel(x, 0)
    ll1, _ = level1(y, lowpass_only=True)
    _, subs2 = qshift_level(ll1)
    h3, w3 = h // 8, w // 8
    masks = torch.ceil(pool_to(mean2x2(magnitudes(subs2)), (h3, w3))
                       / torch.full((), step, dtype=dtype, device=frames.device))
    plane = torch.as_tensor(np.asarray(wm_plane, np.float32), device=frames.device)
    wre, wim = wm_spectrum(plane, dtype)
    scaled = alpha * masks
    d_subs = tree_parts(scaled * corners(wre, (h3, w3)), scaled * corners(wim, (h3, w3)))
    # level 3 -> 2 -> 1 with zero lowpasses, then LeGall level 1
    zero = torch.zeros((n, h3, w3), dtype=dtype, device=frames.device)
    lls = []
    for ci, (rt, ct) in enumerate(_TREES):
        _, _, g0r, g1r, rr = _qshift(rt)
        _, _, g0c, g1c, rc = _qshift(ct)
        lo = _synthesis(zero, d_subs[ci], g0r, g1r, g0c, g1c, 0, 0)
        lls.append(torch.roll(torch.roll(lo, rc, -1), rr, -2))
    ll2 = torch.stack(lls, dim=-3)
    lls = []
    for ci, (rt, ct) in enumerate(_TREES):
        _, _, g0r, g1r, rr = _qshift(rt)
        _, _, g0c, g1c, rc = _qshift(ct)
        lo = _synthesis(ll2[..., ci, :, :], None, g0r, g1r, g0c, g1c, 0, 0)
        lls.append(torch.roll(torch.roll(lo, rc, -1), rr, -2))
    ll1 = torch.stack(lls, dim=-3)
    g0, g1 = _f(F.LEGALL_G0), _f(F.LEGALL_G1)
    du = 0.0
    for ci, (rt, ct) in enumerate(_TREES):
        t = _synthesis(ll1[..., ci, :, :], None, g0, g1, g0, g1, rt, ct)
        du = du + torch.roll(torch.roll(t, F.LEGALL_ROLL, -1), F.LEGALL_ROLL, -2)
    du = du * 0.25
    bwd = torch.as_tensor(colour.M_BWD[:, 1], device=frames.device).to(dtype)
    return colour.to_u8(x + du[..., None] * bwd)
