"""vfp_tpu_torch.ops against vfp_tpu.ops: the same numpy inputs through both.

Tolerance: rtol 1e-5 (float32 sums taken in another order); the colour
constants and the power-step start vector must hold the same bits.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from vfp_tpu.ops import color as jcolor, haar as jhaar, soa as jsoa
from vfp_tpu_torch.ops import color as tcolor, haar as thaar, soa as tsoa

torch.set_num_threads(1)


@pytest.mark.parametrize("name", ["M_FWD", "OFF_FWD", "M_BWD", "OFF_BWD"])
def test_color_constants_bit_identical(name):
    a, b = getattr(jcolor, name), getattr(tcolor, name)
    assert a.dtype == b.dtype == np.float32
    assert a.tobytes() == b.tobytes()


def test_start_vector_bit_identical():
    assert jsoa._V0.tobytes() == tsoa._V0.tobytes()
    assert jsoa._EPS == tsoa._EPS


@pytest.mark.parametrize("fn", ["bgr_to_yuv", "yuv_to_bgr"])
def test_color_conversion_matches_jax(rng, fn):
    x = (rng.rand(2, 9, 11, 3) * 255).astype(np.float32)
    want = np.asarray(getattr(jcolor, fn)(jnp.asarray(x)))
    got = getattr(tcolor, fn)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_color_roundtrip_keeps_chroma_offset_quirk(rng):
    """cv2's float path adds +0.5 to U and V even for 0..255 floats."""
    black = torch.zeros(1, 1, 1, 3)
    np.testing.assert_array_equal(tcolor.bgr_to_yuv(black).numpy().ravel(), [0.0, 0.5, 0.5])


@pytest.mark.parametrize("shape", [(2, 72, 128), (1, 40, 856)])
def test_haar_matches_jax(rng, shape):
    x = (rng.rand(*shape) * 255).astype(np.float32)
    want = jhaar.haar_dwt2(jnp.asarray(x))
    got = thaar.haar_dwt2(torch.from_numpy(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5)
    back = thaar.haar_idwt2(*got).numpy()
    np.testing.assert_allclose(back, np.asarray(jhaar.haar_idwt2(*want)), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(back, x, rtol=1e-5, atol=1e-3)


def test_soa_layout_matches_jax(rng):
    img = rng.rand(2, 36, 64).astype(np.float32)
    want = np.asarray(jsoa.image_to_soa(jnp.asarray(img), 4))
    got = tsoa.image_to_soa(torch.from_numpy(img), 4)
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tsoa.soa_to_image(got, 36, 64, 4).numpy(), img)


@pytest.mark.parametrize("iters", [None, 4])
def test_top_triplet_matches_jax(rng, iters):
    m = (rng.rand(2, 16, 700) * 300).astype(np.float32)
    ws0, wu, wv = (np.asarray(a) for a in jsoa.top_triplet_soa(jnp.asarray(m), iters=iters))
    s0, u, v = (a.numpy() for a in tsoa.top_triplet_soa(torch.from_numpy(m), iters=iters))
    np.testing.assert_allclose(s0, ws0, rtol=2e-5)
    # the rank-1 action is what the codec consumes
    np.testing.assert_allclose(u[:, :, None] * v[:, None], wu[:, :, None] * wv[:, None], atol=2e-5)


def test_top_triplet_zero_blocks_take_the_guards():
    s0, u, v = tsoa.top_triplet_soa(torch.zeros(1, 16, 5))
    assert torch.all(s0 == 0)
    np.testing.assert_array_equal(u[0, :, 0].numpy(), [1, 0, 0, 0])
    np.testing.assert_array_equal(v[0, :, 0].numpy(), tsoa._V0)


def test_rank1_update_matches_jax(rng):
    m = rng.rand(2, 16, 33).astype(np.float32)
    ds = rng.randn(2, 33).astype(np.float32)
    u = rng.randn(2, 4, 33).astype(np.float32)
    v = rng.randn(2, 4, 33).astype(np.float32)
    want = np.asarray(jsoa.rank1_update_soa(*(jnp.asarray(a) for a in (m, ds, u, v))))
    got = tsoa.rank1_update_soa(*(torch.from_numpy(a) for a in (m, ds, u, v))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
