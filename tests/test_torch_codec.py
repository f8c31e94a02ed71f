"""vfp_tpu_torch.wm (codec + payload) and its config against vfp_tpu.

Stated tolerances: the port's ``backend="torch"`` path against the JAX
``backend="xla"`` path marks u8 frames identical on >= 99.9% of pixels
(float32 sums in another order can move a pixel on a .5 rounding edge) and
decodes identical bits.  The ``backend="kernel"`` path (on the CPU: the
kernels' plain versions) follows the Pallas kernels' numerics, which differ
from the XLA path by design: it is held against the JAX ``"pallas"`` path
(kernels in interpret mode) at >= 99.5% of pixels and >= 99.9% of bits with
the payload recovered, and against the XLA path at the 98% that
tests/test_kernels.py pins for the Pallas kernels.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfp_tpu.ops import color as jcolor
from vfp_tpu.utils.config import VfpConfig
from vfp_tpu.wm import DeShuffler as JaxDeShuffler, DwtDctSvd as JaxCodec, Shuffler as JaxShuffler
from vfp_tpu.wm import dwt_dct_svd as jwm, payload as jpayload
from vfp_tpu_torch.utils import make_codec
from vfp_tpu_torch.wm import DeShuffler, DwtDctSvd, Shuffler, block_grid, payload as tpayload

from torch_parity import PAYLOAD, despread, natural_frames, spread_wm

torch.set_num_threads(1)
SHAPES = [(72, 128), (78, 128), (239, 317), (40, 856)]


def _marked_pair(rng, h, w, backend="torch", scales=(0.0, 15.0, 0.0)):
    frames = natural_frames(rng, 2, h, w)
    wm = spread_wm(h, w)
    jax_out = np.asarray(JaxCodec(scales=scales, backend="xla").mark_frames(
        jnp.asarray(frames), jnp.asarray(wm)))
    port_out = DwtDctSvd(scales=scales, backend=backend).mark_frames(
        torch.from_numpy(frames), torch.from_numpy(wm)).numpy()
    return frames, jax_out, port_out


@pytest.mark.parametrize("h,w", SHAPES)
def test_block_grid_and_capacity_match(h, w):
    assert block_grid((h, w)) == jwm.block_grid((h, w))
    assert DwtDctSvd().wm_capacity((h, w, 3)) == JaxCodec().wm_capacity((h, w, 3))


@pytest.mark.parametrize("h,w", SHAPES)
def test_mark_frames_torch_matches_xla(rng, h, w):
    frames, want, got = _marked_pair(rng, h, w)
    assert got.shape == frames.shape and got.dtype == np.uint8
    assert (got == want).mean() >= 0.999


@pytest.mark.parametrize("h,w", SHAPES)
def test_extract_frames_torch_matches_xla(rng, h, w):
    _, marked, _ = _marked_pair(rng, h, w)
    want = np.asarray(JaxCodec(backend="xla").extract_frames(jnp.asarray(marked)))
    got = DwtDctSvd(backend="torch").extract_frames(torch.from_numpy(marked.copy())).numpy()
    np.testing.assert_array_equal(got, want)
    for p in despread(got):
        np.testing.assert_array_equal(p, PAYLOAD)


@pytest.fixture
def pallas_interpret(monkeypatch):
    """The JAX codec's 'pallas' branch on the CPU: its kernels in interpret
    mode, patched where the codec looks them up (as test_kernels.py does)."""
    import vfp_tpu.kernels as jk
    import vfp_tpu.kernels.fused_embed as jfe

    for mod, name in [(jk, "qim_triplet_soa"), (jk, "qim_decode_soa"), (jk, "qim_embed_soa"),
                      (jfe, "fused_mark_planar"), (jfe, "fused_extract_planar")]:
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _fn=fn, **k: _fn(*a, interpret=True, **k))


@pytest.mark.parametrize("h,w", [(72, 128), (239, 317)])
def test_kernel_branch_matches_pallas_branch(rng, pallas_interpret, h, w):
    """backend='kernel' on CPU tensors walks the kernels' plain versions:
    the fused pair for W % 4 == 0, the SoA triplet/decode otherwise."""
    frames = natural_frames(rng, 2, h, w)
    wm = spread_wm(h, w)
    jc = JaxCodec(backend="pallas")
    want = np.asarray(jc.mark_frames(jnp.asarray(frames), jnp.asarray(wm)))
    tc = DwtDctSvd(backend="kernel")
    got = tc.mark_frames(torch.from_numpy(frames), torch.from_numpy(wm)).numpy()
    assert (got == want).mean() >= 0.995
    bits = tc.extract_frames(torch.from_numpy(got)).numpy()
    assert (bits == np.asarray(jc.extract_frames(jnp.asarray(got)))).mean() >= 0.999
    for p in despread(bits):
        np.testing.assert_array_equal(p, PAYLOAD)
    # against the XLA path, the deviation class test_kernels.py pins for the TPU kernels
    xla = np.asarray(JaxCodec(backend="xla").mark_frames(jnp.asarray(frames), jnp.asarray(wm)))
    assert (got == xla).mean() >= 0.98


def test_multichannel_yuv_matches_xla(rng):
    """scales=(5, 15, 0): encode_yuv/decode_yuv and the full colour path."""
    scales = (5.0, 15.0, 0.0)
    frames = natural_frames(rng, 2, 72, 128).astype(np.float32)
    wm = spread_wm(72, 128)
    yuv = np.array(jcolor.bgr_to_yuv(jnp.asarray(frames)))
    jc, tc = JaxCodec(scales=scales, backend="xla"), DwtDctSvd(scales=scales, backend="torch")
    want = np.asarray(jc.encode_yuv(jnp.asarray(yuv), jnp.asarray(wm)))
    got = tc.encode_yuv(torch.from_numpy(yuv), torch.from_numpy(wm)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=2e-3)
    np.testing.assert_array_equal(tc.decode_yuv(torch.from_numpy(got)).numpy(),
                                  np.asarray(jc.decode_yuv(jnp.asarray(want))))
    _, jax_marked, port_marked = _marked_pair(rng, 72, 128, scales=scales)
    assert (port_marked == jax_marked).mean() >= 0.999
    for backend in ("torch", "kernel"):  # the kernel branch: qim_embed_soa's plain version
        marked = DwtDctSvd(scales=scales, backend=backend).mark_frames(
            torch.from_numpy(natural_frames(rng, 2, 72, 128)), torch.from_numpy(wm))
        bits = DwtDctSvd(scales=scales, backend=backend).extract_frames(marked).numpy()
        for p in despread(bits):
            np.testing.assert_array_equal(p, PAYLOAD)


def test_wrong_key_fails_to_recover(rng):
    _, _, marked = _marked_pair(rng, 72, 128)
    bits = DwtDctSvd(backend="torch").extract_frames(torch.from_numpy(marked)).numpy()
    wrong = despread(bits, key=1)
    assert not all(np.array_equal(p, PAYLOAD) for p in wrong)


def test_ll_helpers_match_xla(rng):
    frames = natural_frames(rng, 2, 78, 128).astype(np.float32)
    jc, tc = JaxCodec(backend="xla"), DwtDctSvd(backend="torch")
    want_ll = np.asarray(jc._ll_from_frames(jnp.asarray(frames), 1))
    got_ll = tc._ll_from_frames(torch.from_numpy(frames), 1)
    np.testing.assert_allclose(got_ll.numpy(), want_ll, rtol=1e-5, atol=1e-4)
    want = np.asarray(jc._ll_delta2(jnp.asarray(want_ll), 15.0))
    got = tc._ll_delta2(got_ll, 15.0).numpy()
    assert got.shape == want.shape == (2, 2, 38, 64)
    np.testing.assert_allclose(got, want, atol=2e-3)
    wm = torch.from_numpy(spread_wm(78, 128))
    for bit_plane, b in ((0, 0.0), (1, 1.0)):
        one = tc._ll_delta(got_ll, torch.full_like(wm, b), 15.0).numpy()
        np.testing.assert_array_equal(one, got[bit_plane])  # bit-exact with the two-plane form


@pytest.mark.parametrize("backend,want", [("pallas", "kernel"), ("xla", "torch"), ("auto", "auto")])
def test_from_reference_maps_backend(backend, want):
    c = DwtDctSvd.from_reference(JaxCodec(scales=(5.0, 15.0, 0.0), backend=backend))
    assert c == DwtDctSvd(scales=(5.0, 15.0, 0.0), backend=want)
    assert hash(c) == hash(DwtDctSvd(scales=(5, 15, 0), backend=want))


def test_from_reference_carries_int_path():
    c = DwtDctSvd.from_reference(JaxCodec(int_path=True, backend="pallas"))
    assert c.int_path and c == DwtDctSvd(backend="kernel", int_path=True)
    assert not DwtDctSvd.from_reference(JaxCodec()).int_path


def test_auto_backend_follows_the_tensor_device():
    c = DwtDctSvd()
    assert not c._use_kernel(torch.zeros(1))
    assert DwtDctSvd(backend="kernel")._use_kernel(torch.zeros(1))
    with pytest.raises(ValueError):
        DwtDctSvd(backend="pallas")


# -- payload ---------------------------------------------------------------------

def test_shuffle_and_spread_match(rng):
    for key in (0, 7):
        np.testing.assert_array_equal(tpayload.keyed_shuffle_indices(key, 13),
                                      jpayload.keyed_shuffle_indices(key, 13))
        np.testing.assert_array_equal(Shuffler(key).generate_wm(PAYLOAD, (1, 100)),
                                      JaxShuffler(key).generate_wm(PAYLOAD, (1, 100)))


@pytest.mark.parametrize("threshold", ["midpoint", "fixed"])
def test_deshuffler_matches(rng, threshold):
    planes = (rng.rand(3, 103) > 0.4).astype(np.float32)  # total not a multiple of P
    want = np.asarray(JaxDeShuffler(3, threshold).set_shape((8,)).degenerate_batch(
        jnp.asarray(planes)))
    deg = DeShuffler(3, threshold).set_shape((8,))
    got = deg.degenerate_batch(torch.from_numpy(planes))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(deg.degenerate(planes[0]), want[0])


# -- config ------------------------------------------------------------------------

def test_make_codec_reads_the_shared_config():
    cfg = VfpConfig()
    cfg.codec.scales, cfg.codec.backend = (0.0, 20.0, 0.0), "pallas"
    assert make_codec("dwtDctSvd", cfg) == DwtDctSvd(scales=(0.0, 20.0, 0.0), backend="kernel")
    assert make_codec("dwtDctSvd") == DwtDctSvd()


@pytest.mark.parametrize("name", ["dtcwt_img", "DTCWTIMG", "dtcwtImg"])
def test_make_codec_refuses_unported_codecs(name):
    """Every codec of vfp_tpu is ported: the image codec's names build
    DtcwtImg from ``alpha_img``, and only unknown names are refused."""
    from vfp_tpu_torch.wm import DtcwtImg

    cfg = VfpConfig()
    cfg.codec.alpha_img = 2.5
    assert make_codec(name, cfg) == DtcwtImg(alpha=2.5)
    assert make_codec(name, cfg) == DtcwtImg.from_reference(cfg.make_codec("dtcwtImg"))
    with pytest.raises(ValueError, match="unknown codec"):
        make_codec(name + "x")


@pytest.mark.parametrize("name", ["dtcwt_key", "dtcwtKey"])
def test_make_codec_builds_the_dtcwt_key_codec(name):
    from vfp_tpu_torch.wm import DtcwtKey

    cfg = VfpConfig()
    cfg.codec.alpha_key, cfg.codec.step = 7.0, 4.0
    assert make_codec(name, cfg) == DtcwtKey(alpha=7.0, step=4.0)
    assert make_codec(name, cfg) == DtcwtKey.from_reference(cfg.make_codec("dtcwtKey"))
    assert make_codec(name) == DtcwtKey()
