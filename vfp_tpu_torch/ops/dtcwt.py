"""2-D dual-tree complex wavelet transform (DT-CWT) in PyTorch (port of
``vfp_tpu/ops/dtcwt.py``, real input planes).

The same transform as the JAX package's, with its documented choices:
circular signal extension (exact perfect reconstruction for any filter
pair); level 1 the LeGall 5/3 pair with tree B the one-sample-delayed
sampling phase; levels >= 2 the designed 14-tap q-shift pair, tree B its
time reverse; the 6 subbands the q2c combinations of the 4 row/column tree
mixes, ordered [LH+, LH-, HL+, HL-, HH+, HH-].  Everything is batched over
leading axes.

``Transform2d(backend=...)``: ``"torch"`` runs the plain tensor code below;
``"kernel"`` (and ``"auto"`` for CUDA tensors) takes a CUDA kernel for every
block, as the JAX package routes them to Pallas: level 1 full and
lowpass-only (``kernels/dtcwt_level1.py``: ``dtcwt_level1_analysis``,
``dtcwt_level1_analysis_ll``), the q-shift levels full, lowpass-only and
highpass-only (``dtcwt_qshift_analysis``, ``dtcwt_qshift_ll``,
``dtcwt_qshift_hp``), and the syntheses (``kernels/dtcwt_synthesis.py``:
``dtcwt_qshift_synthesis``, ``dtcwt_qshift_synthesis_ll``,
``dtcwt_legall_synthesis``, ``dtcwt_legall_synthesis_ll``,
``dtcwt_legall_synthesis_hp``).  ``forward``/``inverse`` at any depth and
the raw-plane ``forward_raw``/``inverse_raw`` are built from those blocks.
The plain single-level blocks are the kernels' plain versions; the
replicate pads of odd levels and the inter-level crops stay tensor code.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from . import dtcwt_coeffs as C

BACKENDS = ("auto", "kernel", "torch")
_TREES = ((0, 0), (0, 1), (1, 0), (1, 1))  # (row tree, col tree); 0 = a, 1 = b


# -- 1-D circular filter bank primitives (last axis) ---------------------------------

def _fold(terms):
    acc = terms[0]
    for t in terms[1:]:
        acc = acc + t
    return acc


def down2(x: torch.Tensor, f, phase: int) -> torch.Tensor:
    """y[m] = sum_k f[k] * x[(2m + phase - k) mod N]; [..., N] -> [..., N/2]."""
    return _fold([float(c) * torch.roll(x, k - phase, -1)[..., ::2] for k, c in enumerate(f)])


def up2(y: torch.Tensor, f, phase: int) -> torch.Tensor:
    """x[n] = sum_k f[k] * y2[(n - k) mod N] with y2 = zeros, y2[phase::2] = y."""
    y2 = y.new_zeros((*y.shape[:-1], 2 * y.shape[-1]))
    y2[..., phase::2] = y
    return _fold([float(c) * torch.roll(y2, k, -1) for k, c in enumerate(f)])


def _along_rows(fn, x, *args):
    return fn(x.transpose(-1, -2), *args).transpose(-1, -2)


def _qshift(tree: int):
    """(h0, h1, g0, g1, roll) of the q-shift tree a (0) or b (1)."""
    if tree == 0:
        return C.QSHIFT_H0A, C.QSHIFT_H1A, C.QSHIFT_G0A, C.QSHIFT_G1A, C.QSHIFT_ROLL_A
    return C.QSHIFT_H0B, C.QSHIFT_H1B, C.QSHIFT_G0B, C.QSHIFT_G1B, C.QSHIFT_ROLL_B


# -- per-tree 2-D analysis / synthesis (one level) ----------------------------------

def _analysis2d(x, h0, h1, row_phase, col_phase):
    """One 2-D DWT level -> (ll, lh, hl, hh), each [..., H/2, W/2]."""
    lo = _along_rows(down2, x, h0, row_phase)
    hi = _along_rows(down2, x, h1, row_phase)
    return (down2(lo, h0, col_phase), down2(lo, h1, col_phase),
            down2(hi, h0, col_phase), down2(hi, h1, col_phase))


def _synthesis2d(ll, lh, hl, hh, g0, g1, row_phase, col_phase, roll_r, roll_c):
    lo = up2(ll, g0, col_phase) + up2(lh, g1, col_phase)
    hi = up2(hl, g0, col_phase) + up2(hh, g1, col_phase)
    x = _along_rows(up2, lo, g0, row_phase) + _along_rows(up2, hi, g1, row_phase)
    return torch.roll(torch.roll(x, roll_c, -1), roll_r, -2)


def _qshift_synthesis_tree(ll, lh, hl, hh, rt, ct):
    """One tree of a q-shift synthesis level: [..., h, w] x 4 -> [..., 2h, 2w]."""
    _, _, g0r, g1r, rr = _qshift(rt)
    _, _, g0c, g1c, rc = _qshift(ct)
    lo = torch.roll(up2(ll, g0c, 0) + up2(lh, g1c, 0), rc, -1)
    hi = torch.roll(up2(hl, g0c, 0) + up2(hh, g1c, 0), rc, -1)
    x = _along_rows(up2, lo, g0r, 0) + _along_rows(up2, hi, g1r, 0)
    return torch.roll(x, rr, -2)


# -- q2c / c2q: 4 real tree-mix subbands <-> 2 complex directional subbands ----------

def _q2c(aa, ab, ba, bb):
    zp = torch.complex((aa - bb) * 0.5, (ab + ba) * 0.5)
    zm = torch.complex((aa + bb) * 0.5, (ab - ba) * 0.5)
    return zp, zm


def _c2q(zp, zm):
    aa = zp.real + zm.real
    bb = zm.real - zp.real
    ab = zp.imag + zm.imag
    ba = zp.imag - zm.imag
    return aa, ab, ba, bb


@dataclass
class Pyramid:
    """Real lowpass [..., 2h, 2w] (tree lowpasses interleaved) + per-level
    complex highpasses [..., h, w, 6]; ``sizes`` are the pre-pad sizes per
    level that ``inverse`` crops back to."""

    lowpass: torch.Tensor
    highpasses: tuple
    sizes: list | None = None


def _pad_even(x):
    """Replicate-pad the trailing two axes to even sizes; returns (x, (H, W))."""
    h, w = x.shape[-2], x.shape[-1]
    if h % 2:
        x = torch.cat([x, x[..., -1:, :]], dim=-2)
    if w % 2:
        x = torch.cat([x, x[..., :, -1:]], dim=-1)
    return x, (h, w)


def _pack_planes(ll, subs):
    """(ll dict, subs dict) -> [..., 16, h, w]: [ll*4, lh*4, hl*4, hh*4]."""
    return torch.stack([ll[tc] for tc in _TREES]
                       + [subs[tc][band] for band in range(3) for tc in _TREES], dim=-3)


def _unpack_planes(planes):
    ll, subs = {}, {}
    for ci, tc in enumerate(_TREES):
        ll[tc] = planes[..., ci, :, :]
        subs[tc] = tuple(planes[..., band * 4 + ci, :, :] for band in (1, 2, 3))
    return ll, subs


class Transform2d:
    """forward/inverse, their raw-plane forms and the single-level blocks."""

    def __init__(self, backend: str = "auto"):
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
        self.backend = backend

    def _kernel_mode(self, x: torch.Tensor) -> bool:
        return self.backend == "kernel" or (self.backend == "auto" and x.is_cuda)

    @staticmethod
    def _on_kernel(fn, x: torch.Tensor, planes: int) -> torch.Tensor:
        """``fn`` over the leading axes of [..., planes, h, w]."""
        lead, (h, w) = x.shape[:-3], x.shape[-2:]
        out = fn(x.reshape(-1, planes, h, w))
        return out.reshape(*lead, *out.shape[1:])

    # -- whole transform ---------------------------------------------------------------
    def forward(self, x: torch.Tensor, nlevels: int = 3) -> Pyramid:
        x = x.to(torch.float32)
        squeeze = x.dim() == 2
        if squeeze:
            x = x[None]
        planes, sizes = self.forward_raw(x, nlevels)
        highs = [q2c_planes(p) for p in planes]
        ll = planes[-1]
        h2, w2 = ll.shape[-2:]
        low = x.new_zeros((*ll.shape[:-3], 2 * h2, 2 * w2))
        for ci, (rt, ct) in enumerate(_TREES):
            low[..., rt::2, ct::2] = ll[..., ci, :, :]
        if squeeze:
            low, highs = low[0], [h[0] for h in highs]
        return Pyramid(lowpass=low, highpasses=tuple(highs), sizes=sizes)

    def inverse(self, pyr: Pyramid) -> torch.Tensor:
        low = pyr.lowpass.to(torch.float32)
        highs = pyr.highpasses
        squeeze = low.dim() == 2
        if squeeze:
            low, highs = low[None], tuple(h[None] for h in highs)
        ll4 = torch.stack([low[..., rt::2, ct::2] for rt, ct in _TREES], dim=-3)
        out = self._synthesize(ll4, [c2q_subs(h) for h in highs], pyr.sizes)
        return out[0] if squeeze else out

    def forward_raw(self, x: torch.Tensor, nlevels: int = 3):
        """[..., H, W] -> (planes, sizes): planes[lev] is [..., 16, h, w], the
        level's raw tree planes [ll*4, lh*4, hl*4, hh*4] (its ll planes fed
        the next level; the deepest level's are the final lowpasses, not
        interleaved); sizes[lev] the pre-pad size of the level's input."""
        p, s = self.analysis_level1(x)
        planes, sizes = [p], [s]
        for _ in range(1, nlevels):
            p, s = self.analysis_qshift(p[..., :4, :, :])
            planes.append(p)
            sizes.append(s)
        return planes, sizes

    def inverse_raw(self, planes, sizes=None) -> torch.Tensor:
        """The inverse of ``forward_raw``: the ll planes of every level but
        the deepest are ignored (the reconstruction recomputes them)."""
        return self._synthesize(planes[-1][..., :4, :, :], [p[..., 4:, :, :] for p in planes],
                                sizes)

    def _synthesize(self, ll4, subs, sizes):
        """Deepest tree lowpasses [..., 4, h, w] and each level's highpass
        planes [..., 12, h, w] -> [..., H, W], cropping each level to
        ``sizes`` (if given)."""
        for lev in range(len(subs) - 1, 0, -1):
            ll4 = self.synthesis_qshift(torch.cat([ll4, subs[lev]], dim=-3))
            if sizes is not None:
                ll4 = ll4[..., : sizes[lev][0], : sizes[lev][1]]
        out = self.synthesis_legall(torch.cat([ll4, subs[0]], dim=-3))
        if sizes is not None:
            out = out[..., : sizes[0][0], : sizes[0][1]]
        return out

    # -- single-level blocks ------------------------------------------------------------
    def analysis_level1(self, x: torch.Tensor, lowpass_only: bool = False):
        """[..., H, W] -> ([..., 16, h, w] raw planes, or [..., 4, h, w] tree
        lowpasses when ``lowpass_only``; pre-pad size)."""
        x, orig = _pad_even(x.to(torch.float32))
        if self._kernel_mode(x):
            from ..kernels.dtcwt_level1 import dtcwt_level1_analysis, dtcwt_level1_analysis_ll

            fn = dtcwt_level1_analysis_ll if lowpass_only else dtcwt_level1_analysis
            lead, (h, w) = x.shape[:-2], x.shape[-2:]
            planes = fn(x.reshape(-1, h, w))
            return planes.reshape(*lead, *planes.shape[1:]), orig
        ll, subs = {}, {}
        for rt, ct in _TREES:
            l, lh, hl, hh = _analysis2d(x, C.LEGALL_H0, C.LEGALL_H1, rt, ct)
            ll[(rt, ct)], subs[(rt, ct)] = l, (lh, hl, hh)
        if lowpass_only:
            return torch.stack([ll[tc] for tc in _TREES], dim=-3), orig
        return _pack_planes(ll, subs), orig

    def analysis_qshift(self, ll4: torch.Tensor, lowpass_only: bool = False):
        """[..., 4, h, w] tree lowpasses -> one q-shift analysis level
        ([..., 16 or 4, h/2, w/2], pre-pad size)."""
        stack, lvl = _pad_even(ll4.to(torch.float32))
        if self._kernel_mode(stack):
            from ..kernels.dtcwt_level1 import dtcwt_qshift_analysis, dtcwt_qshift_ll

            fn = dtcwt_qshift_ll if lowpass_only else dtcwt_qshift_analysis
            return self._on_kernel(fn, stack, 4), lvl
        ll, subs = {}, {}
        for ci, (rt, ct) in enumerate(_TREES):
            xi = stack[..., ci, :, :]
            h0r, h1r = _qshift(rt)[:2]
            h0c, h1c = _qshift(ct)[:2]
            lo = _along_rows(down2, xi, h0r, 0)
            ll[(rt, ct)] = down2(lo, h0c, 0)
            if not lowpass_only:
                hi = _along_rows(down2, xi, h1r, 0)
                subs[(rt, ct)] = (down2(lo, h1c, 0), down2(hi, h0c, 0), down2(hi, h1c, 0))
        if lowpass_only:
            return torch.stack([ll[tc] for tc in _TREES], dim=-3), lvl
        return _pack_planes(ll, subs), lvl

    def analysis_qshift_hp(self, ll4: torch.Tensor):
        """[..., 4, h, w] -> ([..., 12, h/2, w/2] planes [lh*4, hl*4, hh*4],
        pre-pad size)."""
        stack, lvl = _pad_even(ll4.to(torch.float32))
        if self._kernel_mode(stack):
            from ..kernels.dtcwt_level1 import dtcwt_qshift_hp

            return self._on_kernel(dtcwt_qshift_hp, stack, 4), lvl
        planes, lvl = self.analysis_qshift(ll4)
        return planes[..., 4:, :, :], lvl

    def synthesis_qshift(self, planes16: torch.Tensor) -> torch.Tensor:
        """[..., 16, h, w] raw planes -> [..., 4, 2h, 2w] tree lowpasses of
        the level below (before cropping)."""
        planes16 = planes16.to(torch.float32)
        if self._kernel_mode(planes16):
            from ..kernels.dtcwt_synthesis import dtcwt_qshift_synthesis

            return self._on_kernel(dtcwt_qshift_synthesis, planes16, 16)
        ll, subs = _unpack_planes(planes16)
        return torch.stack([_qshift_synthesis_tree(ll[tc], *subs[tc], *tc) for tc in _TREES],
                           dim=-3)

    def synthesis_qshift_ll(self, ll4: torch.Tensor) -> torch.Tensor:
        """Lowpass-only q-shift synthesis: [..., 4, h, w] -> [..., 4, 2h, 2w]."""
        ll4 = ll4.to(torch.float32)
        if self._kernel_mode(ll4):
            from ..kernels.dtcwt_synthesis import dtcwt_qshift_synthesis_ll

            return self._on_kernel(dtcwt_qshift_synthesis_ll, ll4, 4)
        outs = []
        for ci, (rt, ct) in enumerate(_TREES):
            _, _, g0r, _, rr = _qshift(rt)
            _, _, g0c, _, rc = _qshift(ct)
            lo = torch.roll(up2(ll4[..., ci, :, :], g0c, 0), rc, -1)
            outs.append(torch.roll(_along_rows(up2, lo, g0r, 0), rr, -2))
        return torch.stack(outs, dim=-3)

    def synthesis_legall(self, planes16: torch.Tensor) -> torch.Tensor:
        """LeGall level-1 synthesis: [..., 16, h, w] raw planes -> [..., 2h,
        2w] (the 4-tree average, before cropping)."""
        planes16 = planes16.to(torch.float32)
        if self._kernel_mode(planes16):
            from ..kernels.dtcwt_synthesis import dtcwt_legall_synthesis

            return self._on_kernel(dtcwt_legall_synthesis, planes16, 16)
        ll, subs = _unpack_planes(planes16)
        out = 0.0
        for rt, ct in _TREES:
            out = out + _synthesis2d(ll[(rt, ct)], *subs[(rt, ct)], C.LEGALL_G0, C.LEGALL_G1,
                                     rt, ct, C.LEGALL_ROLL, C.LEGALL_ROLL)
        return out * 0.25

    def synthesis_legall_hp(self, subs12: torch.Tensor) -> torch.Tensor:
        """Highpass-only LeGall level-1 synthesis: [..., 12, h, w] planes
        [lh*4, hl*4, hh*4] with a zero lowpass -> [..., 2h, 2w]."""
        subs12 = subs12.to(torch.float32)
        if self._kernel_mode(subs12):
            from ..kernels.dtcwt_synthesis import dtcwt_legall_synthesis_hp

            return self._on_kernel(dtcwt_legall_synthesis_hp, subs12, 12)
        out = 0.0
        for ci, (rt, ct) in enumerate(_TREES):
            lh, hl, hh = (subs12[..., band * 4 + ci, :, :] for band in range(3))
            out = out + _synthesis2d(torch.zeros_like(lh), lh, hl, hh, C.LEGALL_G0, C.LEGALL_G1,
                                     rt, ct, C.LEGALL_ROLL, C.LEGALL_ROLL)
        return out * 0.25

    def synthesis_legall_ll(self, ll4: torch.Tensor) -> torch.Tensor:
        """Lowpass-only LeGall level-1 synthesis: [..., 4, h, w] -> [..., 2h, 2w]
        (the 4-tree average)."""
        ll4 = ll4.to(torch.float32)
        if self._kernel_mode(ll4):
            from ..kernels.dtcwt_synthesis import dtcwt_legall_synthesis_ll

            return self._on_kernel(dtcwt_legall_synthesis_ll, ll4, 4)
        out = 0.0
        for ci, (rt, ct) in enumerate(_TREES):
            li = ll4[..., ci, :, :]
            z = torch.zeros_like(li)
            out = out + _synthesis2d(li, z, z, z, C.LEGALL_G0, C.LEGALL_G1, rt, ct,
                                     C.LEGALL_ROLL, C.LEGALL_ROLL)
        return out * 0.25


def q2c_planes(planes: torch.Tensor) -> torch.Tensor:
    """Raw [..., 16, h, w] (or highpass-only [..., 12, h, w]) -> complex
    subbands [..., h, w, 6]."""
    off = planes.shape[-3] - 12
    vals = []
    for band in range(3):
        vals += list(_q2c(*(planes[..., off + band * 4 + i, :, :] for i in range(4))))
    return torch.stack(vals, dim=-1)


def q2c_magnitudes(planes: torch.Tensor) -> torch.Tensor:
    """Raw [..., 16 or 12, h, w] -> |subband| [..., 6, h, w] without complex
    intermediates: |zp| = 0.5 sqrt((aa - bb)^2 + (ab + ba)^2)."""
    off = planes.shape[-3] - 12
    out = []
    for band in range(3):
        aa, ab, ba, bb = (planes[..., off + band * 4 + i, :, :] for i in range(4))
        d, e = aa - bb, ab + ba
        out.append(0.5 * torch.sqrt(d * d + e * e))
        d, e = aa + bb, ab - ba
        out.append(0.5 * torch.sqrt(d * d + e * e))
    return torch.stack(out, dim=-3)


def c2q_subs(high6: torch.Tensor) -> torch.Tensor:
    """Complex subbands [..., h, w, 6] -> raw sub planes [..., 12, h, w]
    [lh*4, hl*4, hh*4] (the inverse of q2c_planes without the ll planes)."""
    outs = []
    for i in range(3):
        outs += list(_c2q(high6[..., 2 * i], high6[..., 2 * i + 1]))
    return torch.stack(outs, dim=-3)
