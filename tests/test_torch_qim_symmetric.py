"""The symmetric form of the dominant triplet (csrc/triplet.cuh) rounds as
the 16-entry form of ``vfp_tpu_torch.kernels.qim._triplet_core``.

The CUDA body keeps G = BᵀB and each of its four squarings as the 10
entries with i <= j and reads (j, i) from (i, j): IEEE multiplication
commutes exactly, and entry (j, i) of a product of symmetric matrices sums
the same products in the same k order as (i, j).  The Frobenius sum keeps
its 16 terms in row-major order, each mirrored square in its own place.
``_triplet_sym`` below is that order written in torch; it must give the
16-entry form's s0, u and v bit for bit on random blocks at three scales,
on blocks that take each eps guard, and on blocks whose s0 sits on a QIM
bin edge.  (On the CPU, torch's vectorised sqrt may not be the correctly
rounded one; both forms go through the same calls on the same shapes, so
the comparison still holds them to one rounding.)

Against the JAX package's Pallas decode (interpret mode): the bits are equal
wherever the two s0 are equal, and on the random blocks everywhere.  The
JAX core takes ``lax.rsqrt`` where the port takes 1/sqrt, so about half
the s0 differ from the JAX ones by an ulp or more (at most 1e-4 relative
here); a block whose s0 sits within a few ulp of a bin edge may then decode
otherwise, and on the bin-edge blocks some do.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfp_tpu.kernels import qim as jqim
from vfp_tpu_torch.kernels import qim as tqim
from vfp_tpu_torch.ops.soa import _EPS, _V0

SCALE = 15.0
N_RANDOM = 1 << 17


def sym(i, j):
    """Index of entry (i, j) of a symmetric 4x4 among its 10 upper-triangle values."""
    return i * 4 - i * (i - 1) // 2 + (j - i) if i <= j else sym(j, i)


def _triplet_sym(rows, guards=None):
    """``_triplet_core`` in the CUDA body's order: 10 Gram entries, 10 a
    squaring, (j, i) read from (i, j).  ``guards``, if given, collects the
    mask of each eps guard."""
    g = [None] * 10
    for a in range(4):
        for b in range(a, 4):
            acc = rows[0 * 4 + a] * rows[0 * 4 + b]
            for r in range(1, 4):
                acc = acc + rows[r * 4 + a] * rows[r * 4 + b]
            g[sym(a, b)] = acc
    sq = [gi * gi for gi in g]
    fro = sq[0]
    for i in range(1, 16):
        fro = fro + sq[sym(i // 4, i % 4)]
    if guards is not None:
        guards["fro"] = fro <= _EPS
        guards["trace"] = torch.zeros_like(fro, dtype=torch.bool)
    inv = tqim._inv_sqrt(torch.clamp(fro, min=_EPS))
    g = [gi * inv for gi in g]
    for _ in range(4):
        g2 = [None] * 10
        for i in range(4):
            for j in range(i, 4):
                acc = g[sym(i, 0)] * g[sym(0, j)]
                for k in range(1, 4):
                    acc = acc + g[sym(i, k)] * g[sym(k, j)]
                g2[sym(i, j)] = acc
        tr = g2[sym(0, 0)] + g2[sym(1, 1)] + g2[sym(2, 2)] + g2[sym(3, 3)]
        if guards is not None:
            guards["trace"] |= tr <= _EPS
        inv = torch.reciprocal(torch.clamp(tr, min=_EPS))
        g = [gi * inv for gi in g2]

    v0 = [float(x) for x in _V0]
    v = [None] * 4
    for i in range(4):
        acc = g[sym(i, 0)] * v0[0]
        for j in range(1, 4):
            acc = acc + g[sym(i, j)] * v0[j]
        v[i] = acc
    vn = v[0] * v[0] + v[1] * v[1] + v[2] * v[2] + v[3] * v[3]
    bad = vn <= _EPS
    inv = tqim._inv_sqrt(torch.clamp(vn, min=_EPS))
    v = [torch.where(bad, torch.full_like(vi, v0[i]), vi * inv) for i, vi in enumerate(v)]

    bv = [None] * 4
    for r in range(4):
        acc = rows[r * 4 + 0] * v[0]
        for c in range(1, 4):
            acc = acc + rows[r * 4 + c] * v[c]
        bv[r] = acc
    s0sq = bv[0] * bv[0] + bv[1] * bv[1] + bv[2] * bv[2] + bv[3] * bv[3]
    s0 = torch.sqrt(s0sq)
    zero = s0 <= _EPS
    if guards is not None:
        guards["G v0"], guards["s0"] = bad, zero
    inv = tqim._inv_sqrt(torch.clamp(s0sq, min=_EPS))
    u = [torch.where(zero, torch.full_like(bv[r], 1.0 if r == 0 else 0.0), bv[r] * inv)
         for r in range(4)]
    return s0, u, v


def _assert_same_triplet(m: np.ndarray, guards=None):
    rows = [torch.from_numpy(m[:, i]) for i in range(16)]
    s0, u, v = _triplet_sym(rows, guards)
    ws0, wu, wv = tqim._triplet_core(rows)
    assert torch.equal(s0, ws0)
    assert all(torch.equal(a, b) for a, b in zip(u, wu))
    assert all(torch.equal(a, b) for a, b in zip(v, wv))
    return s0


def _random_blocks(scale: float) -> np.ndarray:
    rng = np.random.RandomState({1e-3: 11, 1.0: 12, 300.0: 13}[scale])
    m = rng.rand(4, 16, N_RANDOM // 4).astype(np.float32) * np.float32(scale)
    m[:, :, ::2] -= np.float32(scale / 2)  # signed entries in half the blocks
    return m


def _guard_blocks() -> np.ndarray:
    """Blocks that take each eps guard: zero blocks (every guard), blocks of
    1e-22 (s0 under eps), blocks of 1e-15 (G's Frobenius sum and the traces
    under eps, G v0 under eps, s0 above), rank-1 blocks x yᵀ at 1e-12 to 1
    with y nearly orthogonal to the start vector."""
    rng = np.random.RandomState(21)
    zero = np.zeros((16, 64), np.float32)
    tiny = rng.rand(16, 256).astype(np.float32) * np.float32(1e-22)
    small = rng.rand(16, 256).astype(np.float32) * np.float32(1e-15)
    x = rng.randn(4, 256).astype(np.float32)
    y = np.stack([_V0[1], -_V0[0], _V0[3], -_V0[2]]).astype(np.float32)[:, None] \
        + rng.randn(4, 256).astype(np.float32) * np.float32(1e-4)
    mag = np.float32(10.0) ** rng.randint(-12, 1, 256).astype(np.float32)
    rank1 = (x[:, None] * y[None] * mag).reshape(16, 256).astype(np.float32)
    return np.concatenate([zero, tiny, small, rank1], axis=1)[None]


def _bin_edge_blocks() -> np.ndarray:
    """Blocks whose s0 is a QIM bin edge k * scale / 2 in exact arithmetic:
    c on one entry (any of the 16 places), and rank-1 blocks c x yᵀ with x,
    y unit vectors, for c = k * 7.5, k = 1..64."""
    rng = np.random.RandomState(22)
    cs = np.float32(SCALE / 2) * np.arange(1, 65, dtype=np.float32)
    onehot = np.zeros((16, 16, 64), np.float32)
    for i in range(16):
        onehot[i, i] = cs
    x = rng.randn(4, 64)
    y = rng.randn(4, 64)
    x, y = x / np.linalg.norm(x, axis=0), y / np.linalg.norm(y, axis=0)
    rank1 = (x[:, None] * y[None] * cs).reshape(16, 64).astype(np.float32)
    return np.concatenate([onehot.reshape(16, 16 * 64), rank1], axis=1)[None]


@pytest.mark.parametrize("scale", [1e-3, 1.0, 300.0])
def test_symmetric_form_equals_triplet_core_on_random_blocks(scale):
    _assert_same_triplet(_random_blocks(scale))


def test_symmetric_form_equals_triplet_core_at_each_eps_guard():
    guards = {}
    _assert_same_triplet(_guard_blocks(), guards)
    assert set(guards) == {"fro", "trace", "G v0", "s0"}
    for name, hit in guards.items():
        assert bool(hit.any()) and not bool(hit.all()), name


def test_symmetric_form_equals_triplet_core_on_bin_edges():
    m = _bin_edge_blocks()
    s0 = _assert_same_triplet(m)
    # s0 within 2 ulp of the edge: the bit is decided by the last bits
    edge = torch.from_numpy(np.float32(SCALE / 2) * np.tile(np.arange(1, 65, dtype=np.float32),
                                                            17))[None]
    assert bool(((s0 - edge).abs() <= 2 * torch.finfo(torch.float32).eps * edge).all())
    bits = tqim.qim_bit(s0, SCALE)
    assert 0 < float(bits.mean()) < 1


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("case", ["1e-3", "1", "300", "bin edges"])
def test_symmetric_bits_against_the_pallas_decode(case):
    m = _bin_edge_blocks() if case == "bin edges" else _random_blocks(float(case))
    s0 = _assert_same_triplet(m).numpy()
    bits = tqim.qim_bit(torch.from_numpy(s0), SCALE).numpy()
    want = np.asarray(jqim.qim_decode_soa(jnp.asarray(m), SCALE, interpret=True))
    ws0 = np.asarray(jqim.qim_triplet_soa(jnp.asarray(m), interpret=True)[0])
    same = s0 == ws0
    assert np.array_equal(bits[same], want[same])
    assert float(np.max(np.abs(s0 - ws0) / np.maximum(ws0, np.float32(1e-30)))) <= 1e-4
    if case != "bin edges":
        assert np.array_equal(bits, want)
        return
    # on a bin edge the last bits decide: a bit differs only where the two s0
    # differ by a few ulp and sit within a few ulp of the edge
    differ = bits != want
    assert differ.any() and not differ.all()
    assert int(_ulps(s0[differ], ws0[differ]).max()) <= 3
    rem = np.fmod(ws0[differ], np.float32(SCALE))
    near = np.minimum(np.abs(rem - np.float32(SCALE / 2)),
                      np.minimum(rem, np.float32(SCALE) - rem))
    assert bool((near <= 4 * np.spacing(ws0[differ])).all())
