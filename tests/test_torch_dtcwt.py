"""The DT-CWT key codec's mark path in vfp_tpu_torch against vfp_tpu, on the CPU.

The same numpy inputs go through the JAX function and its port.  The JAX
codec is built with ``fast_dots=False`` (its default True rounds the Pallas
kernels' operands to bf16, which the quantized masks turn into whole
steps); its Pallas kernels run in interpret mode with ``fast=False``.
Stated tolerances:

- the plain transform (``ops/dtcwt.py``) against ``Transform2d("xla")``:
  atol 2e-5 on [0, 1] data (float32 sums in another order); perfect
  reconstruction atol 2e-3 on 0-255 data, as tests/test_dtcwt.py;
- ``filter2d_mean2x2`` / ``rebin_mean``: atol 1e-5; the cv2-free resize
  against ``cv2.resize``: atol 1e-6; ``correlation_batch``: atol 1e-5;
- the kernels' plain versions against the Pallas kernels: level 1 atol 2e-4
  (0-255 data), the masks EQUAL (ceil amplifies any last-bit difference into
  a whole step, as tests/test_dtcwt.py:348-363 pins for the Pallas kernel),
  the delta synthesis atol 2e-6;
- the codec's kernel path against the JAX codec: >= 99.5% of marked pixels
  identical, the rest within 1, masks identical; its tensor path: >= 99.9%
  identical, within 2 (one mask value on a ceil edge may take the other
  step); detection through the JAX extractor within 0.01 of JAX-marked
  frames.
"""

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfp_tpu.cli.__main__ import main as jax_cli
from vfp_tpu.kernels import dtcwt_delta as jdelta, dtcwt_level1 as jl1, dtcwt_masks as jmasks
from vfp_tpu.ops import dtcwt as jdt, dtcwt_coeffs as jcoeffs, filters as jfilters
from vfp_tpu.ops.color import bgr_to_yuv as jax_bgr_to_yuv
from vfp_tpu.wm import dtcwt_codecs as jcodecs, payload_img as jpimg
from vfp_tpu_torch import kernels
from vfp_tpu_torch.cli import main as port_cli
from vfp_tpu_torch.io import RawVideoReader, RawVideoWriter
from vfp_tpu_torch.kernels import dtcwt_delta as tdelta, dtcwt_level1 as tl1, dtcwt_masks as tmasks
from vfp_tpu_torch.kernels import dtcwt_synthesis as tsyn
from vfp_tpu_torch.ops import dtcwt as tdt, dtcwt_coeffs as tcoeffs, filters as tfilters
from vfp_tpu_torch.utils import make_codec
from vfp_tpu_torch.wm import CorrShuffler, DeCorrShuffler, DtcwtKey, dtcwt_codecs as tcodecs

from test_dwt_dct_svd import natural_frames as smooth_frames
from torch_parity import natural_frames

torch.set_num_threads(1)
COEFFS = [n for n in dir(jcoeffs) if n.isupper()]
JAX_CODEC = jcodecs.DtcwtKey(fast_dots=False)


def _np(x):
    return np.asarray(x)


# -- ops/dtcwt_coeffs, ops/filters ----------------------------------------------------

@pytest.mark.parametrize("name", COEFFS)
def test_coefficients_bit_identical(name):
    a, b = np.asarray(getattr(jcoeffs, name)), np.asarray(getattr(tcoeffs, name))
    assert a.dtype == b.dtype and np.array_equal(a, b)


def test_filter2d_mean2x2_matches_jax_and_cv2(rng):
    x = rng.rand(3, 20, 30).astype(np.float32)
    got = tfilters.filter2d_mean2x2(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, _np(jfilters.filter2d_mean2x2(jnp.asarray(x))), atol=1e-5)
    want = cv2.filter2D(x[0], -1, np.full((2, 2), 0.25))
    np.testing.assert_allclose(got[0], want, atol=1e-5)


@pytest.mark.parametrize("h", [8, 7])
def test_rebin_mean_matches_jax(rng, h):
    a = rng.rand(2, h, 12).astype(np.float32)
    got = tfilters.rebin_mean(torch.from_numpy(a), (4, 6)).numpy()
    np.testing.assert_allclose(got, _np(jfilters.rebin_mean(jnp.asarray(a), (4, 6))), atol=1e-5)


@pytest.mark.parametrize("src,dst", [((1080, 1920), (136, 240)), ((1080, 1920), (60, 108)),
                                     ((1080, 1920), (16, 32)), ((50, 70), (120, 33))])
def test_resize_linear_matches_cv2(src, dst):
    img = jpimg._keyed_pm1_plane(7, src)
    want = cv2.resize(img, (dst[1], dst[0]))
    np.testing.assert_allclose(tfilters.resize_linear(img, dst), want, atol=1e-6, rtol=0)


# -- ops/dtcwt ----------------------------------------------------------------------

@pytest.mark.parametrize("phase", [0, 1])
@pytest.mark.parametrize("f", ["LEGALL_H0", "LEGALL_G1", "QSHIFT_H0A", "QSHIFT_G1B"])
def test_down2_up2_match_jax(rng, f, phase):
    x = rng.rand(2, 5, 24).astype(np.float32)
    taps = getattr(jcoeffs, f)
    np.testing.assert_allclose(tdt.down2(torch.from_numpy(x), taps, phase).numpy(),
                               _np(jdt.down2(jnp.asarray(x), taps, phase)), atol=2e-5)
    np.testing.assert_allclose(tdt.up2(torch.from_numpy(x), taps, phase).numpy(),
                               _np(jdt.up2(jnp.asarray(x), taps, phase)), atol=2e-5)


@pytest.mark.parametrize("shape", [(32, 48), (30, 42)])
def test_single_level_blocks_match_jax(rng, shape):
    jt, tt = jdt.Transform2d(backend="xla"), tdt.Transform2d("torch")
    x = rng.rand(2, *shape).astype(np.float32)
    for lowpass_only in (False, True):
        got, gs = tt.analysis_level1(torch.from_numpy(x), lowpass_only=lowpass_only)
        want, ws = jt.analysis_level1(jnp.asarray(x), lowpass_only=lowpass_only)
        assert gs == ws
        np.testing.assert_allclose(got.numpy(), _np(want), atol=2e-5)
    ll4 = rng.rand(2, 4, shape[0] // 2, shape[1] // 2).astype(np.float32)
    for lowpass_only in (False, True):
        got, _ = tt.analysis_qshift(torch.from_numpy(ll4), lowpass_only=lowpass_only)
        want, _ = jt.analysis_qshift(jnp.asarray(ll4), lowpass_only=lowpass_only)
        np.testing.assert_allclose(got.numpy(), _np(want), atol=2e-5)
    np.testing.assert_allclose(tt.analysis_qshift_hp(torch.from_numpy(ll4))[0].numpy(),
                               _np(jt.analysis_qshift_hp(jnp.asarray(ll4))[0]), atol=2e-5)
    p16 = rng.rand(2, 16, 8, 12).astype(np.float32)
    np.testing.assert_allclose(tt.synthesis_qshift(torch.from_numpy(p16)).numpy(),
                               _np(jt.synthesis_qshift(jnp.asarray(p16))), atol=2e-5)
    for name in ("synthesis_qshift_ll", "synthesis_legall_ll"):
        np.testing.assert_allclose(getattr(tt, name)(torch.from_numpy(p16[:, :4])).numpy(),
                                   _np(getattr(jt, name)(jnp.asarray(p16[:, :4]))), atol=2e-5)
    np.testing.assert_allclose(tt.synthesis_legall_hp(torch.from_numpy(p16[:, 4:])).numpy(),
                               _np(jt.synthesis_legall_hp(jnp.asarray(p16[:, 4:]))), atol=2e-5)


@pytest.mark.parametrize("shape", [(32, 32), (30, 42), (31, 41)])
def test_forward_matches_jax_and_reconstructs(rng, shape):
    jt, tt = jdt.Transform2d(backend="xla"), tdt.Transform2d("torch")
    x = rng.rand(*shape).astype(np.float32)
    for nl in (1, 2, 3):
        got, want = tt.forward(torch.from_numpy(x), nlevels=nl), jt.forward(jnp.asarray(x), nl)
        np.testing.assert_allclose(got.lowpass.numpy(), _np(want.lowpass), atol=2e-5)
        for g, w in zip(got.highpasses, want.highpasses):
            assert g.dtype == torch.complex64 and g.shape == w.shape
            np.testing.assert_allclose(g.numpy(), _np(w), atol=2e-5)
        rec = tt.inverse(tt.forward(torch.from_numpy(x * 255), nlevels=nl)).numpy()
        np.testing.assert_allclose(rec, x * 255, atol=2e-3)


def test_q2c_helpers_match_jax(rng):
    p = rng.randn(2, 16, 6, 10).astype(np.float32)
    np.testing.assert_allclose(tdt.q2c_planes(torch.from_numpy(p)).numpy(),
                               _np(jdt.q2c_planes(jnp.asarray(p))), atol=2e-5)
    np.testing.assert_allclose(tdt.q2c_magnitudes(torch.from_numpy(p[:, 4:])).numpy(),
                               _np(jdt.q2c_magnitudes(jnp.asarray(p[:, 4:]))), atol=2e-5)
    z = (rng.randn(2, 6, 10, 6) + 1j * rng.randn(2, 6, 10, 6)).astype(np.complex64)
    np.testing.assert_allclose(tdt.c2q_subs(torch.from_numpy(z)).numpy(),
                               _np(jdt.c2q_subs(jnp.asarray(z))), atol=2e-5)


def test_kernel_backend_raises_where_no_kernel_is_ported(rng):
    """Named for the refusals it pinned before every block had a kernel: the
    kernel backend now routes each of those blocks to its wrapper, whose
    plain version on the CPU equals the plain transform without a launch;
    only an unknown backend still raises."""
    t, plain = tdt.Transform2d("kernel"), tdt.Transform2d("torch")
    x = torch.from_numpy(rng.rand(1, 16, 16).astype(np.float32))
    kernels.reset_launch_counts()
    assert t.forward(x, nlevels=1).highpasses[0].shape == (1, 8, 8, 6)
    got, want = t.forward(x, nlevels=2), plain.forward(x, nlevels=2)
    assert torch.equal(got.lowpass, want.lowpass)
    assert all(torch.equal(a, b) for a, b in zip(got.highpasses, want.highpasses, strict=True))
    assert torch.equal(t.analysis_level1(x, True)[0], plain.analysis_level1(x, True)[0])
    ll4 = x[:, None].expand(1, 4, 16, 16)
    assert torch.equal(t.synthesis_qshift_ll(ll4), plain.synthesis_qshift_ll(ll4))
    assert not any(kernels.launch_counts().values())
    with pytest.raises(ValueError):
        tdt.Transform2d("xla")


# -- wm/payload_img -------------------------------------------------------------------

@pytest.mark.parametrize("cap", [(136, 240), (16, 32), (60, 108)])
def test_corr_shuffler_matches_jax(cap):
    np.testing.assert_allclose(CorrShuffler(3).generate_wm(None, cap),
                               jpimg.CorrShuffler(3).generate_wm(None, cap), atol=1e-6, rtol=0)


@pytest.mark.parametrize("key", [3, 99])
def test_correlation_batch_matches_jax(rng, key):
    planes = rng.randn(3, 30, 60).astype(np.float32)
    planes[1] += 0.5 * CorrShuffler(3).generate_wm(None, (30, 60))
    deg, jdeg = DeCorrShuffler(key), jpimg.DeCorrShuffler(key)
    got = deg.correlation_batch(torch.from_numpy(planes)).numpy()
    np.testing.assert_allclose(got, _np(jdeg.correlation_batch(jnp.asarray(planes))), atol=1e-5)
    np.testing.assert_array_equal(deg.degenerate_batch(torch.from_numpy(planes)).numpy(),
                                  _np(jdeg.degenerate_batch(jnp.asarray(planes))))
    assert deg.degenerate(planes[1]) == (key == 3)


# -- the kernels' plain versions against the Pallas kernels ------------------------------

# (b, h, w): three shapes at B = 2 and the CUDA tile's edges
# (tests/test_torch_cuda.py): a frame smaller than one tile and its halo,
# h1 % 8 and w1 % 32 != 0, W % 4 == 2, B = 1 and 32; the Pallas kernel takes
# the kernel_eligible shapes, the JAX codec's XLA path (bgr_to_yuv, then the
# XLA level 1) the others
LL_U8_CASES = [(2, 64, 128), (2, 68, 192), (2, 128, 256), (1, 6, 10), (2, 38, 100),
               (32, 72, 136), (2, 236, 318), (1, 64, 128), (32, 24, 64)]


def ll_u8_ids(cases):
    """'h-w' at B = 2 (the ids the cases had before B varied), 'bB-h-w' else."""
    return [f"{h}-{w}" if b == 2 else f"b{b}-{h}-{w}" for b, h, w in cases]


def jax_level1_ll(f, channels, pallas):
    """The JAX package's level-1 lowpasses of u8 frames' first ``channels``
    YUV channels: the Pallas kernel (in interpret mode) where it takes the
    shape, else the XLA path."""
    if jl1.kernel_eligible(*f.shape[1:3]):
        return _np(pallas(jnp.asarray(f), interpret=True))
    yuv = jnp.moveaxis(jax_bgr_to_yuv(jnp.asarray(f, jnp.float32))[..., :channels], -1, 1)
    ll, _ = jdt.Transform2d(backend="xla").analysis_level1(yuv, lowpass_only=True)
    return _np(ll[:, 0] if channels == 1 else ll)


@pytest.mark.parametrize("b,h,w", LL_U8_CASES, ids=ll_u8_ids(LL_U8_CASES))
def test_level1_ll_y_matches_pallas(rng, b, h, w):
    f = rng.randint(0, 256, (b, h, w, 3)).astype(np.uint8)
    got = tl1.dtcwt_level1_ll_y(torch.from_numpy(f)).numpy()
    np.testing.assert_allclose(got, jax_level1_ll(f, 1, jl1.dtcwt_level1_analysis_ll_y),
                               atol=2e-4)
    if jl1.chain_eligible(h, w):  # the chained twin's valid window
        m = jl1.CHAIN_MARGIN // 2
        raw = _np(jl1.dtcwt_level1_ll_y_chain(jnp.asarray(f), interpret=True))
        np.testing.assert_allclose(got, raw[..., m: m + h // 2, m: m + w // 2], atol=2e-4)


@pytest.mark.parametrize("h,w", [(64, 128), (136, 240)])
def test_level1_analysis_matches_pallas(rng, h, w):
    x = (rng.rand(2, h, w) * 255).astype(np.float32)
    got = tl1.dtcwt_level1_analysis(torch.from_numpy(x)).numpy()
    want = _np(jl1.dtcwt_level1_analysis(jnp.asarray(x), interpret=True))
    np.testing.assert_allclose(got, want, atol=2e-4)


# (4, 4): one mask output, the 46 x 116 window wrapping many times; (36, 100)
# and (68, 104): mask grids 9 x 25 and 17 x 26, not multiples of the kernel's
# 8 x 24 tile; the Pallas kernel takes only masks_eligible shapes
@pytest.mark.parametrize("h,w", [(64, 128), (68, 192), (132, 256), (4, 4), (36, 100), (68, 104)])
def test_masks_equal_pallas_and_the_xla_chain(rng, h, w):
    ll4 = (rng.rand(2, 4, h, w) * 100).astype(np.float32)
    got = tmasks.dtcwt_qshift_masks(torch.from_numpy(ll4), 5.0).numpy()
    if jmasks.masks_eligible(h, w):
        np.testing.assert_array_equal(got, _np(jmasks.dtcwt_qshift_masks(
            jnp.asarray(ll4), step=5.0, interpret=True, fast=False)))
    t = jdt.Transform2d(backend="xla")
    hp2, _ = t.analysis_qshift_hp(jnp.asarray(ll4))
    m = jfilters.filter2d_mean2x2(jdt.q2c_magnitudes(hp2))
    want = _np(jnp.ceil(jfilters.rebin_mean(m, (h // 4, w // 4)) / 5.0))
    np.testing.assert_array_equal(got, want)


def test_masks_equal_the_chained_pallas_kernel(rng):
    h, w = 128, 256
    f = jnp.asarray(rng.randint(0, 256, (2, h, w, 3)).astype(np.uint8))
    raw = jl1.dtcwt_level1_ll_y_chain(f, interpret=True)
    want = _np(jmasks.dtcwt_qshift_masks_chain(raw, (h // 8, w // 8), step=5.0, interpret=True))
    got = tmasks.dtcwt_qshift_masks(tl1.dtcwt_level1_ll_y(torch.from_numpy(np.array(f))), 5.0)
    np.testing.assert_array_equal(got.numpy(), want)


# (1, 1) and (2, 3): planes smaller than the kernel's level-3 window (19 x
# 28), which wraps many times; (17, 48): a 136 x 384 delta, not a multiple of
# its 64 x 128 tile; the Pallas kernel takes only delta_eligible shapes
@pytest.mark.parametrize("h3,w3", [(17, 32), (16, 48), (34, 64), (1, 1), (2, 3), (17, 48)])
def test_delta_synthesis_matches_pallas_and_the_chain(rng, h3, w3):
    d = rng.randn(2, 12, h3, w3).astype(np.float32)
    got = tdelta.dtcwt_delta_synthesis(torch.from_numpy(d)).numpy()
    assert got.shape == (2, 8 * h3, 8 * w3)
    if jdelta.delta_eligible(h3, w3):
        np.testing.assert_allclose(got, _np(jdelta.dtcwt_delta_synthesis(
            jnp.asarray(d), interpret=True)), atol=2e-6)
    t = jdt.Transform2d(backend="xla")  # the JAX three-stage chain
    d3 = jnp.concatenate([jnp.zeros((2, 4, h3, w3)), jnp.asarray(d)], axis=1)
    chain = t.synthesis_legall_ll(t.synthesis_qshift_ll(t.synthesis_qshift(d3)))
    np.testing.assert_allclose(got, _np(chain), atol=2e-6)


@pytest.mark.parametrize("call", [
    lambda: tl1.dtcwt_level1_ll_y(torch.zeros(1, 8, 8, 4, dtype=torch.uint8)),
    lambda: tl1.dtcwt_level1_ll_y(torch.zeros(1, 7, 8, 3, dtype=torch.uint8)),
    lambda: tl1.dtcwt_level1_analysis(torch.zeros(1, 8, 8, dtype=torch.float64)),
    lambda: tmasks.dtcwt_qshift_masks(torch.zeros(1, 4, 6, 8)),
    lambda: tmasks.dtcwt_qshift_masks(torch.zeros(1, 3, 8, 8)),
    lambda: tdelta.dtcwt_delta_synthesis(torch.zeros(1, 11, 4, 4)),
    lambda: tl1.dtcwt_level1_ll_color(torch.zeros(1, 8, 8, 3)),
    lambda: tl1.dtcwt_level1_ll_color(torch.zeros(1, 8, 8, 4, dtype=torch.uint8)),
    lambda: tl1.dtcwt_level1_ll_color(torch.zeros(1, 8, 7, 3, dtype=torch.uint8)),
    lambda: tl1.dtcwt_qshift_ll(torch.zeros(1, 4, 8, 8, dtype=torch.float64)),
    lambda: tl1.dtcwt_qshift_ll(torch.zeros(4, 8, 8)),
    lambda: tl1.dtcwt_qshift_ll(torch.zeros(1, 3, 8, 8)),
    lambda: tl1.dtcwt_qshift_hp(torch.zeros(1, 4, 7, 8)),
    lambda: tl1.dtcwt_qshift_hp(torch.zeros(1, 4, 8, 9)),
    lambda: tsyn.dtcwt_legall_synthesis_hp(torch.zeros(1, 11, 4, 4)),
    lambda: tsyn.dtcwt_legall_synthesis_hp(torch.zeros(1, 12, 4, 4, dtype=torch.float64)),
    lambda: tsyn.dtcwt_legall_synthesis_hp(torch.zeros(12, 4, 4)),
    lambda: tl1.dtcwt_level1_analysis_ll(torch.zeros(1, 8, 8, dtype=torch.uint8)),
    lambda: tl1.dtcwt_qshift_analysis(torch.zeros(1, 3, 8, 8)),
    lambda: tsyn.dtcwt_qshift_synthesis(torch.zeros(1, 15, 4, 4)),
    lambda: tsyn.dtcwt_qshift_synthesis_ll(torch.zeros(1, 4, 4, 4, dtype=torch.float64)),
    lambda: tsyn.dtcwt_legall_synthesis(torch.zeros(16, 4, 4)),
    lambda: tsyn.dtcwt_legall_synthesis_ll(torch.zeros(1, 5, 4, 4)),
])
def test_kernel_wrappers_reject_malformed_input(call):
    with pytest.raises(ValueError):
        call()


def test_plain_versions_on_the_cpu_count_no_launch(rng):
    kernels.reset_launch_counts()
    f = torch.from_numpy(natural_frames(rng, 1, 64, 128))
    tdelta.dtcwt_delta_synthesis(torch.zeros(1, 12, 8, 16))
    tmasks.dtcwt_qshift_masks(tl1.dtcwt_level1_ll_y(f))
    assert not any(kernels.launch_counts().values())


# -- the codec ---------------------------------------------------------------------------

def test_wm_geometry_helpers_match_jax(rng):
    for shape in ((1080, 1920, 3), (68, 192, 3), (239, 317, 3)):
        assert tcodecs.infer_wm_shape(shape) == jcodecs.infer_wm_shape(shape)
    c = rng.randn(6, 68, 120).astype(np.float32)
    np.testing.assert_array_equal(tcodecs._corner_replicate(torch.from_numpy(c), (135, 240)),
                                  _np(jcodecs._corner_replicate(jnp.asarray(c), (135, 240))))
    x = rng.randn(2, 6, 135, 240).astype(np.float32)
    np.testing.assert_allclose(tcodecs._fold_corners(torch.from_numpy(x), 68, 120).numpy(),
                               _np(jcodecs._fold_corners(jnp.asarray(x), 68, 120)), atol=1e-5)


def _frames_and_wm(rng, h, w, key=3):
    f = natural_frames(rng, 2, h, w)
    return f, jpimg.CorrShuffler(key).generate_wm(None, JAX_CODEC.wm_capacity((h, w, 3)))


@pytest.mark.parametrize("h,w", [(128, 256), (480, 856)])
def test_kernel_path_marks_as_jax(rng, h, w):
    f, wm = _frames_and_wm(rng, h, w)
    want = _np(JAX_CODEC.mark_frames(jnp.asarray(f), jnp.asarray(wm)))
    got = DtcwtKey(backend="kernel").mark_frames(torch.from_numpy(f), torch.from_numpy(wm))
    d = np.abs(got.numpy().astype(int) - want)
    assert got.dtype == torch.uint8 and got.shape == f.shape
    assert (d == 0).mean() >= 0.995 and d.max() <= 1, ((d == 0).mean(), d.max())
    # the masks: the kernel's plain version against the JAX codec's own chain
    y = jax_bgr_to_yuv(jnp.asarray(f, jnp.float32))[..., 0]
    jt = jdt.Transform2d(backend="xla")
    hp2, _ = jt.analysis_qshift_hp(jt.analysis_level1(y, lowpass_only=True)[0])
    jm = _np(JAX_CODEC._masks3_from_mags(jdt.q2c_magnitudes(hp2), (h // 8, w // 8)))
    tm = tmasks.dtcwt_qshift_masks(tl1.dtcwt_level1_ll_y(torch.from_numpy(f)), 5.0).numpy()
    np.testing.assert_array_equal(np.moveaxis(tm, 1, -1), jm)


@pytest.mark.parametrize("h,w", [(68, 192), (128, 256)])
def test_tensor_path_marks_as_jax(rng, h, w):
    f, wm = _frames_and_wm(rng, h, w)
    want = _np(JAX_CODEC.mark_frames(jnp.asarray(f), jnp.asarray(wm)))
    got = DtcwtKey(backend="torch").mark_frames(torch.from_numpy(f), torch.from_numpy(wm))
    d = np.abs(got.numpy().astype(int) - want)
    assert (d == 0).mean() >= 0.999 and d.max() <= 2, ((d == 0).mean(), d.max())


def test_jax_detects_the_port_marks(rng):
    h, w = 240, 320
    f = smooth_frames(rng, b=2, h=h, w=w)  # the content tests/test_dtcwt.py marks
    wm = jpimg.CorrShuffler(3).generate_wm(None, JAX_CODEC.wm_capacity((h, w, 3)))
    port = DtcwtKey().mark_frames(torch.from_numpy(f), torch.from_numpy(wm)).numpy()
    jax_marked = JAX_CODEC.mark_frames(jnp.asarray(f), jnp.asarray(wm))
    psnr = 10 * np.log10(255 ** 2 / np.mean((port.astype(float) - f) ** 2))
    assert psnr > 35, psnr
    corr = {}
    for key in (3, 99):
        deg = jpimg.DeCorrShuffler(key)
        corr[key] = _np(deg.correlation_batch(JAX_CODEC.extract_frames(jnp.asarray(port))))
        ref = _np(deg.correlation_batch(JAX_CODEC.extract_frames(jax_marked)))
        np.testing.assert_allclose(corr[key], ref, atol=0.01)
    assert (corr[3] > 0.1).all() and (corr[99] < 0.1).all(), corr
    # the port's own tensor-path extract reads the same planes
    planes = DtcwtKey().extract_frames(torch.from_numpy(port))
    np.testing.assert_allclose(planes.numpy(), _np(JAX_CODEC.extract_frames(jnp.asarray(port))),
                               atol=1e-4)
    np.testing.assert_allclose(DeCorrShuffler(3).correlation_batch(planes).numpy(), corr[3],
                               atol=1e-5)


def test_kernel_path_refuses_shapes_without_exact_levels(rng):
    """Named for the refusal it pinned before the three-stage synthesis had
    kernels: at 68x192 (H % 8 != 0) the kernel path marks and extracts as
    the JAX codec, through the mask glue and the synthesis wrappers."""
    h, w = 68, 192
    f, wm = _frames_and_wm(rng, h, w)
    want = _np(JAX_CODEC.mark_frames(jnp.asarray(f), jnp.asarray(wm)))
    codec = DtcwtKey(backend="kernel")
    got = codec.mark_frames(torch.from_numpy(f), torch.from_numpy(wm)).numpy()
    d = np.abs(got.astype(int) - want)
    assert (d == 0).mean() >= 0.999 and d.max() <= 2, ((d == 0).mean(), d.max())
    planes = codec.extract_frames(torch.from_numpy(np.array(want)))
    yuv = jax_bgr_to_yuv(jnp.asarray(want, jnp.float32))
    np.testing.assert_allclose(planes.numpy(),
                               _np(JAX_CODEC._decode_channel_raw(yuv[..., 0], yuv[..., 1])),
                               atol=1e-4)


def test_codec_config_and_reference():
    assert make_codec("dtcwtKey") == make_codec("dtcwt_key") == DtcwtKey(alpha=10.0, step=5.0)
    assert DtcwtKey.from_reference(jcodecs.DtcwtKey(alpha=7.0, step=4.0)) == DtcwtKey(7.0, 4.0)
    assert DtcwtKey().wm_capacity((1080, 1920, 3)) == (136, 240)
    with pytest.raises(ValueError):
        DtcwtKey(backend="pallas")
    assert DtcwtKey.from_reference(jcodecs.DtcwtKey(nlevels=2)) == DtcwtKey(nlevels=2)
    # the image variant's mask normalisation carries across too
    assert DtcwtKey.from_reference(jcodecs.DtcwtImg()) == DtcwtKey(alpha=1.5,
                                                                   normalize_masks=True)
    with pytest.raises(ValueError):
        DtcwtKey(nlevels=1)


def _read(path):
    r = RawVideoReader(path)
    try:
        return r.read_batch(1000)
    finally:
        r.close()


def test_cli_dtcwt_key_round_trip_matches_the_jax_cli(rng, tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("VFP_LOWLINK", "0")
    src, jax_out, port_out = (tmp_path / n for n in ("src.rawv", "jax.rawv", "port.rawv"))
    with RawVideoWriter(src, 320, 240, fps=6) as w:
        w.write_batch(natural_frames(rng, 4, 240, 320))
    jax_cli(["mark", str(src), str(jax_out), "--codec", "dtcwtKey", "--batch-size", "2"])
    port_cli(["mark", str(src), str(port_out), "--codec", "dtcwtKey", "--batch-size", "2",
              "--device", "cpu"])
    assert "marked 4 frames" in capsys.readouterr().out
    a, b = _read(jax_out), _read(port_out)
    assert a.shape == b.shape == (4, 240, 320, 3)
    assert (a == b).mean() >= 0.999
    for key, present in ((0, "4/4"), (99, "0/4")):
        jax_cli(["detect", str(jax_out), "--codec", "dtcwtKey", "--key", str(key)])
        jax_lines = capsys.readouterr().out
        port_cli(["detect", str(port_out), "--codec", "dtcwtKey", "--key", str(key),
                  "--device", "cpu"])
        port_lines = capsys.readouterr().out
        for lines in (jax_lines, port_lines):
            assert "frames: 4" in lines and f"watermark present in {present} frames" in lines
