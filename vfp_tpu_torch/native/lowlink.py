"""The host half of the LL-domain transport (``pipeline/lowlink.py``) over
the native library's ``lowlink.cpp``, each function beside its NumPy twin
(``<name>_reference``).

The C functions fix the QIM block at 4x4, the flagship codec's; the twins
take any block size, and ``pipeline/lowlink.py`` calls them for another.
The twins are the functions' plain statements, for the tests: host_ll's is
the C source's float order and agrees to the bit, reconstruct's is the same
int16 table add, the QIM twins solve the same triplet in NumPy's order and
agree in their decisions.  The library is built with g++ at first use; a
build that fails raises.
"""

from __future__ import annotations

import numpy as np

from ..ops.soa import _EPS, _V0
from .build import load_lowlink

DLL_Q = 8.0  # int8 fixed-point scale of the LL delta: |dll| < 15 => |q| <= 120 < 127


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


# -- host_ll ---------------------------------------------------------------------

def host_ll(frames: np.ndarray, m, off: float) -> np.ndarray:
    """[k, H, W, 3] u8 BGR -> [k, h4/2, w4/2] f16 LL of the channel
    ``m @ [B, G, R] + off`` (h4, w4: H, W cut to multiples of 4)."""
    k, h, w, _ = frames.shape
    h4, w4 = h // 4 * 4, w // 4 * 4
    src = np.ascontiguousarray(frames, np.uint8)
    out = np.empty((k, h4 // 2, w4 // 2), np.float16)
    load_lowlink().vfpio_host_ll(_ptr(src), _ptr(out), k, h, w, h4, w4,
                                 float(m[0]), float(m[1]), float(m[2]), float(off))
    return out


def host_ll_reference(frames: np.ndarray, m, off: float) -> np.ndarray:
    k, h, w, _ = frames.shape
    h4, w4 = h // 4 * 4, w // 4 * 4
    x = frames[:, :h4, :w4].astype(np.float32)
    m0, m1, m2 = (np.float32(v) for v in m)
    c = m0 * x[..., 0] + m1 * x[..., 1] + m2 * x[..., 2] + np.float32(off)
    s = c[:, 0::2, 0::2] + c[:, 0::2, 1::2] + c[:, 1::2, 0::2] + c[:, 1::2, 1::2]
    return (s * np.float32(0.5)).astype(np.float16)


# -- reconstruct -------------------------------------------------------------------

def reconstruct(frames: np.ndarray, dll: np.ndarray, luts, out=None) -> np.ndarray:
    """[k, H, W, 3] u8 + int8 LL delta [k, hc, wc] -> marked [k, H, W, 3]
    (into ``out``, a C-contiguous u8 array of that shape, where given):
    clip(x + lut_c[dll + 128]) on each 2x2 quad of the [2hc, 2wc] region,
    for each channel c whose table ``luts[c]`` (int16 [256]) is not None."""
    k, h, w, _ = frames.shape
    hc, wc = dll.shape[-2:]
    src = np.ascontiguousarray(frames, np.uint8)
    d = np.ascontiguousarray(dll, np.int8)
    if out is None:
        out = np.empty_like(src)
    elif out.shape != src.shape or out.dtype != np.uint8 or not out.flags["C_CONTIGUOUS"]:
        raise ValueError(f"reconstruct writes into a C-contiguous u8 {src.shape} array")
    ptrs = [None if t is None else _ptr(t) for t in luts]
    load_lowlink().vfpio_reconstruct(_ptr(src), _ptr(d), *ptrs, _ptr(out), k, h, w, hc, wc)
    return out


def reconstruct_reference(frames: np.ndarray, dll: np.ndarray, luts) -> np.ndarray:
    k = len(frames)
    hc, wc = dll.shape[-2:]
    h2, w2 = 2 * hc, 2 * wc
    idx = dll.astype(np.int16) + 128
    out = frames.copy()
    for ch, lut in enumerate(luts):
        if lut is None:
            continue
        x16 = frames[:, :h2, :w2, ch].astype(np.int16).reshape(k, hc, 2, wc, 2)
        m = x16 + lut[idx][:, :, None, :, None]
        np.clip(m, 0, 255, out=m)
        out[:, :h2, :w2, ch] = m.astype(np.uint8).reshape(k, h2, w2)
    return out


# -- the QIM functions of the host wire --------------------------------------------

def _bits_u8(plane_bits: np.ndarray, nb: int) -> np.ndarray:
    return np.ascontiguousarray((np.asarray(plane_bits)[:, :nb] > 0.5).astype(np.uint8))


def qim_dll(ll16: np.ndarray, plane_bits: np.ndarray, scale: float) -> np.ndarray:
    """f16 LL [k, hc, wc] + block bits [P, >= nb] -> int8 QIM LL delta
    [P, k, hc, wc] (4x4 blocks, row-major; zero past the block grid)."""
    k, hc, wc = ll16.shape
    P = len(plane_bits)
    pb = _bits_u8(plane_bits, (hc // 4) * (wc // 4))
    llc = np.ascontiguousarray(ll16, np.float16)
    out = np.empty((P, k, hc, wc), np.int8)
    load_lowlink().vfpio_qim_dll(_ptr(llc), _ptr(pb), _ptr(out), P, k, hc, wc, float(scale))
    return out


def triplet_reference(x: np.ndarray):
    """[m, n, n] -> (s0 [m], u [m, n], v [m, n]): the twin of lowlink.cpp's
    ``triplet4`` (and of ops.soa.top_triplet_soa): 5 Frobenius-normalized
    squarings of the Gram matrix, v from ``_V0``."""
    n = x.shape[-1]
    g = np.einsum("mra,mrb->mab", x, x)
    for _ in range(5):
        norm = np.sqrt((g * g).sum((-2, -1), keepdims=True))
        g = g / np.maximum(norm, _EPS)
        g = g @ g
    v = g @ _V0[:n]
    vn = np.linalg.norm(v, axis=1, keepdims=True)
    v = np.where(vn > _EPS, v / np.maximum(vn, _EPS), _V0[:n])
    bv = np.einsum("mrc,mc->mr", x, v)
    s0 = np.linalg.norm(bv, axis=1)
    e0 = np.zeros_like(bv)
    e0[:, 0] = 1.0
    u = np.where(s0[:, None] > _EPS, bv / np.maximum(s0[:, None], _EPS), e0)
    return s0, u, v


def _blocks(ll16: np.ndarray, blk: int) -> np.ndarray:
    """[k, hc, wc] -> [k * nbh * nbw, blk, blk] f32 blocks, row-major."""
    k, hc, wc = ll16.shape
    nbh, nbw = hc // blk, wc // blk
    return (ll16[:, : nbh * blk, : nbw * blk].astype(np.float32)
            .reshape(k, nbh, blk, nbw, blk).transpose(0, 1, 3, 2, 4).reshape(-1, blk, blk))


def qim_dll_reference(ll16: np.ndarray, plane_bits: np.ndarray, scale: float,
                      blk: int = 4) -> np.ndarray:
    k, hc, wc = ll16.shape
    nbh, nbw = hc // blk, wc // blk
    rh, rw = nbh * blk, nbw * blk
    s0, u, v = triplet_reference(_blocks(ll16, blk))
    outer = u[:, :, None] * v[:, None, :]
    cell = np.floor(s0 / scale)
    out = np.zeros((len(plane_bits), k, hc, wc), np.int8)
    for p, bits in enumerate(plane_bits):
        bits = np.tile(np.asarray(bits).reshape(-1)[: nbh * nbw].astype(np.float32), k)
        d = ((cell + 0.25 + 0.5 * bits) * scale - s0)[:, None, None] * outer
        dq = np.clip(np.rint(d * DLL_Q), -127, 127).astype(np.int8)
        out[p, :, :rh, :rw] = (dq.reshape(k, nbh, nbw, blk, blk)
                               .transpose(0, 1, 3, 2, 4).reshape(k, rh, rw))
    return out


def qim_bits(ll16: np.ndarray, scale: float) -> np.ndarray:
    """f16 LL [k, hc, wc] -> decoded bits u8 [k, nbh * nbw] (4x4 blocks):
    (s0 mod scale) > scale / 2."""
    k, hc, wc = ll16.shape
    llc = np.ascontiguousarray(ll16, np.float16)
    out = np.empty((k, (hc // 4) * (wc // 4)), np.uint8)
    load_lowlink().vfpio_qim_bits(_ptr(llc), _ptr(out), k, hc, wc, float(scale))
    return out


def qim_bits_reference(ll16: np.ndarray, scale: float, blk: int = 4) -> np.ndarray:
    s0, _, _ = triplet_reference(_blocks(ll16, blk))
    return (np.mod(s0, scale) > scale * 0.5).astype(np.uint8).reshape(len(ll16), -1)


def qim_repair(out: np.ndarray, small: np.ndarray, ll16: np.ndarray,
               plane_bits: np.ndarray, scale: float) -> None:
    """Overwrite, in place, each block of ``out`` (int8 [P, k, hc, wc],
    C-contiguous) flagged in ``small`` ([P, k, nbh, nbw]) with the QIM delta
    of the true f16 LL under that plane's bit (4x4 blocks)."""
    if not out.flags["C_CONTIGUOUS"] or out.dtype != np.int8:
        raise ValueError("qim_repair writes into a C-contiguous int8 array")
    P, k, hc, wc = out.shape
    pb = _bits_u8(plane_bits, (hc // 4) * (wc // 4))
    llc = np.ascontiguousarray(ll16, np.float16)
    mc = np.ascontiguousarray(small.astype(np.uint8))
    load_lowlink().vfpio_qim_repair(_ptr(llc), _ptr(mc), _ptr(pb), _ptr(out), P, k, hc, wc,
                                    float(scale))


def qim_repair_reference(out: np.ndarray, small: np.ndarray, ll16: np.ndarray,
                         plane_bits: np.ndarray, scale: float, blk: int = 4) -> None:
    P, k, nbh, nbw = small.shape
    ki, ii, ji = np.nonzero(small.any(0))
    xb = (ll16[:, : nbh * blk, : nbw * blk].astype(np.float32)
          .reshape(k, nbh, blk, nbw, blk).transpose(0, 1, 3, 2, 4))[ki, ii, ji]
    s0, u, v = triplet_reference(xb)
    base = np.floor(s0 / scale) + 0.25
    for p in range(P):
        sel = small[p, ki, ii, ji]
        bit = np.asarray(plane_bits[p]).reshape(-1)[ii[sel] * nbw + ji[sel]]
        ds = (base[sel] + 0.5 * bit.astype(np.float32)) * scale - s0[sel]
        blocks = np.clip(np.rint((ds[:, None, None] * u[sel][:, :, None] * v[sel][:, None, :])
                                 * np.float32(DLL_Q)), -127, 127).astype(np.int8)
        for t, (kk, a, c) in enumerate(zip(ki[sel], ii[sel], ji[sel])):
            out[p, kk, a * blk:(a + 1) * blk, c * blk:(c + 1) * blk] = blocks[t]


# -- the u8 wire's recentring ---------------------------------------------------------

def recentre(dll_q: np.ndarray, E: np.ndarray, ll: np.ndarray, blk: int, du_min: float,
             gamma2: float):
    """int8 wire deltas [P, k, hc, wc], wire error E and true LL ``ll``
    ([k, hc, wc] f32) -> (rescaled int8 deltas, flags u8 [P, k, nbh, nbw]):
    each block scaled by 1 - DLL_Q * <q, E> / ||q||^2, except the blocks
    below the direction floor or failing the direction gate, which keep
    their values and are flagged for ``qim_repair``."""
    P, k, hc, wc = dll_q.shape
    qc = np.ascontiguousarray(dll_q, np.int8)
    ec = np.ascontiguousarray(E, np.float32)
    xc = np.ascontiguousarray(ll, np.float32)
    out = qc.copy()
    small = np.zeros((P, k, hc // blk, wc // blk), np.uint8)
    load_lowlink().vfpio_recentre2(_ptr(qc), _ptr(ec), _ptr(xc), _ptr(out), _ptr(small),
                                   P, k, hc, wc, blk, DLL_Q, float(du_min), float(gamma2))
    return out, small


def block_ac(a: np.ndarray, blk: int) -> np.ndarray:
    """Per-block AC energy ||B - mean(B)||_F^2 of [k, hc, wc] -> [k, nbh, nbw]."""
    k, hc, wc = a.shape
    nbh, nbw = hc // blk, wc // blk
    v = a[:, : nbh * blk, : nbw * blk].astype(np.float32).reshape(k, nbh, blk, nbw, blk)
    s = v.sum((2, 4))
    return (v * v).sum((2, 4)) - s * s * np.float32(1.0 / (blk * blk))


def recentre_reference(dll_q: np.ndarray, E: np.ndarray, ll: np.ndarray, blk: int,
                       du_min: float, gamma2: float):
    P, k, hc, wc = dll_q.shape
    nbh, nbw = hc // blk, wc // blk
    rh, rw = nbh * blk, nbw * blk
    flat = block_ac(ll, blk) < gamma2 * block_ac(E, blk)  # [k, nbh, nbw]
    q = dll_q[:, :, :rh, :rw].astype(np.float32).reshape(P, k, nbh, blk, nbw, blk)
    ev = np.asarray(E, np.float32)[:, :rh, :rw].reshape(k, nbh, blk, nbw, blk)
    num = np.einsum("pkabcd,kabcd->pkac", q, ev)
    den = np.einsum("pkabcd,pkabcd->pkac", q, q)
    small = (den < du_min * du_min * DLL_Q * DLL_Q) | flat[None]
    alpha = np.where(small, 1.0, 1.0 - DLL_Q * num / np.maximum(den, 1e-12)).astype(np.float32)
    out = dll_q.copy()
    scaled = q * alpha[:, :, :, None, :, None]
    out[:, :, :rh, :rw] = np.clip(np.rint(scaled), -127, 127).astype(np.int8).reshape(
        P, k, rh, rw)
    return out, small.astype(np.uint8)
