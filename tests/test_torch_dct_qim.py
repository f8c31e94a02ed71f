"""The DCT-QIM slice of vfp_tpu_torch against vfp_tpu, on the CPU.

The same numpy inputs (``torch_parity.natural_frames``) go through the JAX
function and its port.  Stated tolerances:

- ``ops/dct`` and the SoA Kronecker DCT: allclose(rtol=1e-5, atol=1e-3) on
  0-255 data (float32 sums in another order);
- the masks: allclose(rtol=1e-6) with NaN where the reference has NaN, so
  every branch decision is the same (a branch taken the other way moves a
  mask value by >= 0.125);
- the codec's ``"torch"`` path against the JAX ``"xla"`` path: decoded bits
  identical, marked u8 within 1 with >= 99.9% identical;
- the kernels' plain versions against the Pallas kernels in interpret mode
  (as tests/test_dct_qim.py runs them): mark within 1 with >= 98% identical
  (the bound tests/test_dct_qim.py pins), extract bits identical and the
  payload despread to 01100101; the Y-mean pre-pass rtol 1e-6 against the
  JAX float32 mean, and equal to an exact integer sum of Y * 2^27.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfp_tpu import pipeline as jpipe
from vfp_tpu.cli.__main__ import main as jax_cli
from vfp_tpu.kernels import fused_dct_qim as jk
from vfp_tpu.ops import dct as jdct, soa as jsoa
from vfp_tpu.utils.config import VfpConfig as JaxConfig
from vfp_tpu.wm import dct_qim as jwm
from vfp_tpu_torch import kernels, pipeline as tpipe
from vfp_tpu_torch.cli import main as port_cli
from vfp_tpu_torch.io import RawVideoReader, RawVideoWriter
from vfp_tpu_torch.kernels import fused_dct_qim as tk
from vfp_tpu_torch.ops import dct as tdct, soa as tsoa
from vfp_tpu_torch.utils import VfpConfig, make_codec
from vfp_tpu_torch.wm import DctQim, dct_qim as twm

from torch_parity import PAYLOAD, despread, natural_frames, spread_wm

torch.set_num_threads(1)
ALPHA = 20.0
# 64x128; 32x856 (107 block columns, a prime); 72x136 (H not a multiple of 64)
SHAPES = [(64, 128), (32, 856), (72, 136)]


def _flat_frames(rng, h=64, w=128):
    """Natural frames with whole 8x8 blocks of black, white and mid-grey:
    their texture-mask divisions are 0/0 and x/0."""
    f = natural_frames(rng, 2, h, w)
    f[:, :8, :24] = 0
    f[:, 8:16, :24] = 255
    f[:, 16:32, 8:40] = 128
    f[1, 32:, :] = 128  # a frame whose lower half is one flat field
    return f


def _xla_marked(frames, wm):
    return np.asarray(jwm.DctQim(alpha=ALPHA, backend="xla").mark_frames(
        jnp.asarray(frames), jnp.asarray(wm)))


def _wm2d(h, w):
    return spread_wm(h, w)[: (h // 8) * (w // 8)].reshape(h // 8, w // 8)


def _payloads(bits2d):
    """[B, nbh, nbw] bits -> [B, 8] payloads."""
    return despread(bits2d.reshape(len(bits2d), -1))  # H, W % 8 == 0: nbh * nbw is the capacity


# -- ops ----------------------------------------------------------------------------

def test_dct_matrices_bit_identical():
    assert tdct.dct_matrix(8).tobytes() == jdct.dct_matrix(8).tobytes()
    assert tsoa.dct_kron(8).tobytes() == jsoa.dct_kron(8).tobytes()
    assert tsoa.dct_kron(4).tobytes() == jsoa.dct_kron(4).tobytes()


@pytest.mark.parametrize("n", [8, 4])
def test_dct2_and_idct2_match_jax(rng, n):
    x = (rng.rand(2, 5, n, n) * 255).astype(np.float32)
    got = tdct.dct2(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jdct.dct2(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-3)
    back = tdct.idct2(got).numpy()
    np.testing.assert_allclose(back, np.asarray(jdct.idct2(jdct.dct2(jnp.asarray(x)))),
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(back, x, rtol=1e-5, atol=1e-3)


def test_dct_soa_and_idct_soa_match_jax(rng):
    x = (rng.rand(2, 64, 37) * 255).astype(np.float32)
    got = tsoa.dct_soa(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jsoa.dct_soa(jnp.asarray(x))),
                               rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(tsoa.idct_soa(got).numpy(),
                               np.asarray(jsoa.idct_soa(jsoa.dct_soa(jnp.asarray(x)))),
                               rtol=1e-5, atol=1e-3)


def test_dct_products_refuse_tf32(monkeypatch):
    class FakeCuda(torch.Tensor):
        is_cuda = True

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    with pytest.raises(RuntimeError, match="allow_tf32"):
        tdct.full_f32(torch.zeros(1).as_subclass(FakeCuda))
    tdct.full_f32(torch.zeros(1))  # the CPU never runs TF32


# -- masks --------------------------------------------------------------------------

def _y_blocks(frames):
    """[B, H, W, 3] u8 -> the JAX package's Y DCT blocks [B, 64, N] as numpy."""
    from vfp_tpu.ops.color import bgr_to_yuv

    y = bgr_to_yuv(jnp.asarray(frames, jnp.float32))[..., 0]
    return np.array(jsoa.dct_soa(jsoa.image_to_soa(y, 8)))


@pytest.mark.parametrize("content", ["natural", "noise", "flat"])
def test_masks_match_jax(rng, content):
    if content == "flat":
        frames = _flat_frames(rng)
    elif content == "noise":  # sharp texture: the edge and ramp branches
        frames = (rng.rand(2, 64, 128, 3) * 255).astype(np.uint8)
    else:
        frames = natural_frames(rng, 2, 64, 128)
    blocks = _y_blocks(frames)
    want_t = np.asarray(jwm.texture_mask(jnp.asarray(blocks)))
    got_t = twm.texture_mask(torch.from_numpy(blocks)).numpy()
    np.testing.assert_allclose(got_t, want_t, rtol=1e-6)
    want_l = np.asarray(jwm.luminance_mask(jnp.asarray(blocks[:, 0])))
    got_l = twm.luminance_mask(torch.from_numpy(blocks[:, 0])).numpy()
    np.testing.assert_allclose(got_l, want_l, rtol=1e-6)
    if content == "noise":
        assert (want_t != 1.0).any()  # branches actually exercised


def test_flat_blocks_take_the_reference_branches(rng):
    """A flat block has e == h == l == 0: l/e and (l+e)/h are NaN, every
    comparison is false, and the texture mask is 1 (eh <= 125)."""
    blocks = np.zeros((1, 64, 3), np.float32)
    blocks[0, 0] = [0.0, 2040.0, 1024.0]  # black, white, mid-grey DC
    got = twm.texture_mask(torch.from_numpy(blocks)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jwm.texture_mask(jnp.asarray(blocks))))
    np.testing.assert_array_equal(got, [[1.0, 1.0, 1.0]])
    lum = twm.luminance_mask(torch.from_numpy(blocks[:, 0])).numpy()
    np.testing.assert_allclose(lum, np.asarray(jwm.luminance_mask(jnp.asarray(blocks[:, 0]))),
                               rtol=1e-6)


# -- the codec's torch path vs the XLA path ------------------------------------------

@pytest.mark.parametrize("h,w", SHAPES + [(70, 130)])
def test_mark_frames_torch_matches_xla(rng, h, w):
    frames = natural_frames(rng, 2, h, w)
    wm = spread_wm(h, w)
    want = _xla_marked(frames, wm)
    got = DctQim(alpha=ALPHA, backend="torch").mark_frames(
        torch.from_numpy(frames), torch.from_numpy(wm)).numpy()
    assert got.shape == frames.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.999


@pytest.mark.parametrize("h,w", SHAPES + [(70, 130)])
def test_extract_frames_torch_matches_xla(rng, h, w):
    marked = _xla_marked(natural_frames(rng, 2, h, w), spread_wm(h, w))
    want = np.asarray(jwm.DctQim(alpha=ALPHA, backend="xla").extract_frames(jnp.asarray(marked)))
    got = DctQim(alpha=ALPHA, backend="torch").extract_frames(
        torch.from_numpy(marked.copy())).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(despread(got), np.tile(PAYLOAD, (2, 1)))


def test_flat_frames_torch_matches_xla(rng):
    frames = _flat_frames(rng)
    wm = spread_wm(64, 128)
    want = _xla_marked(frames, wm)
    got = DctQim(alpha=ALPHA, backend="torch").mark_frames(
        torch.from_numpy(frames), torch.from_numpy(wm)).numpy()
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.999
    np.testing.assert_array_equal(
        DctQim(backend="torch").extract_frames(torch.from_numpy(want.copy())).numpy(),
        np.asarray(jwm.DctQim(backend="xla").extract_frames(jnp.asarray(want))))


# -- the kernels' plain versions vs the Pallas kernels (interpret mode) ----------------

@pytest.mark.parametrize("h,w", SHAPES)
def test_mark_reference_matches_pallas(rng, h, w):
    frames = natural_frames(rng, 2, h, w)
    planes = frames.transpose(0, 3, 1, 2).copy()
    wm2d = _wm2d(h, w)
    want = np.asarray(jk.fused_dct_qim_mark(jnp.asarray(planes), jnp.asarray(wm2d), ALPHA,
                                            interpret=True))
    got = tk.fused_dct_qim_mark_reference(torch.from_numpy(planes), torch.from_numpy(wm2d),
                                          ALPHA).numpy()
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.98
    np.testing.assert_array_equal(got[:, 2], planes[:, 2])  # M_BWD[2, 1] == 0: passthrough


# The CUDA mark's strip is 4 tile rows x 16 tiles: W % 16 != 0 (136: 8-byte
# staging), nbw % 16 != 0 (17, 33 tiles), nbh % 4 and % 8 != 0 (9, 25 tile
# rows), one tile, B = 1 and B = 32.
STRIP_EDGES = [(1, 72, 136), (1, 8, 8), (2, 24, 264), (32, 16, 16), (1, 200, 136)]


@pytest.mark.parametrize("b,h,w", STRIP_EDGES)
def test_mark_reference_matches_pallas_at_the_strip_edges(rng, b, h, w):
    planes = natural_frames(rng, b, h, w).transpose(0, 3, 1, 2).copy()
    wm2d = rng.randint(0, 2, (h // 8, w // 8)).astype(np.float32)
    want = np.asarray(jk.fused_dct_qim_mark(jnp.asarray(planes), jnp.asarray(wm2d), ALPHA,
                                            interpret=True))
    got = tk.fused_dct_qim_mark_reference(torch.from_numpy(planes), torch.from_numpy(wm2d),
                                          ALPHA).numpy()
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.98
    np.testing.assert_array_equal(got[:, 2], planes[:, 2])


@pytest.mark.parametrize("h,w", SHAPES)
def test_extract_reference_matches_pallas(rng, h, w):
    planes = natural_frames(rng, 2, h, w).transpose(0, 3, 1, 2).copy()
    marked = np.asarray(jk.fused_dct_qim_mark(jnp.asarray(planes), jnp.asarray(_wm2d(h, w)),
                                              ALPHA, interpret=True))
    want = np.asarray(jk.fused_dct_qim_extract(jnp.asarray(marked), ALPHA, interpret=True))
    got = tk.fused_dct_qim_extract_reference(torch.from_numpy(marked.copy()), ALPHA).numpy()
    assert got.shape == (2, h // 8, w // 8)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_payloads(got), np.tile(PAYLOAD, (2, 1)))


def test_kernel_plain_versions_on_flat_frames_match_pallas(rng):
    planes = _flat_frames(rng).transpose(0, 3, 1, 2).copy()
    wm2d = _wm2d(64, 128)
    want = np.asarray(jk.fused_dct_qim_mark(jnp.asarray(planes), jnp.asarray(wm2d), ALPHA,
                                            interpret=True))
    got = tk.fused_dct_qim_mark_reference(torch.from_numpy(planes), torch.from_numpy(wm2d),
                                          ALPHA).numpy()
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.98
    np.testing.assert_array_equal(
        tk.fused_dct_qim_extract_reference(torch.from_numpy(want.copy()), ALPHA).numpy(),
        np.asarray(jk.fused_dct_qim_extract(jnp.asarray(want), ALPHA, interpret=True)))


@pytest.mark.parametrize("h,w", SHAPES)
@pytest.mark.parametrize("content", ["natural", "flat"])
def test_extract_takes_its_own_means_as_pallas(rng, h, w, content):
    """The extract (its plain version on the CPU) takes each frame's mean
    itself, as the Pallas kernel does, and decodes as that kernel."""
    frames = _flat_frames(rng, h, w) if content == "flat" else natural_frames(rng, 2, h, w)
    planes = frames.transpose(0, 3, 1, 2).copy()
    marked = np.asarray(jk.fused_dct_qim_mark(jnp.asarray(planes), jnp.asarray(_wm2d(h, w)),
                                              ALPHA, interpret=True))
    x = torch.from_numpy(marked.copy())
    got = tk.fused_dct_qim_extract(x, ALPHA)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jk.fused_dct_qim_extract(jnp.asarray(marked), ALPHA,
                                                         interpret=True)))
    if content == "natural":
        np.testing.assert_array_equal(_payloads(got.numpy()), np.tile(PAYLOAD, (2, 1)))


def test_every_u8_pixel_has_an_integer_fixed_point_y():
    """The property the exact Y mean rests on, for all 2^24 (B, G, R): the
    plain version's float32 Y times ``Y_SCALE`` (2^27) is an integer below
    2^35.  Chunks of 16 blue values, G down the rows and R across."""
    assert tk.Y_SCALE == 2.0 ** 27
    g, r = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    for b0 in range(0, 256, 16):
        planes = np.empty((16, 3, 256, 256), np.uint8)
        planes[:, 0] = np.arange(b0, b0 + 16)[:, None, None]
        planes[:, 1], planes[:, 2] = g, r
        fixed = tk._lincomb(torch.from_numpy(planes), 0).to(torch.float64) * tk.Y_SCALE
        assert torch.equal(fixed, torch.floor(fixed)), b0
        assert float(fixed.min()) >= 0 and float(fixed.max()) < 2.0 ** 35, b0


def _exact_mean(planes):
    """Per frame: the Python-integer sum of Y * 2^27 over the 8-aligned crop,
    and the float32 mean from the exact rational, rounded to a double first."""
    from fractions import Fraction

    h8, w8 = planes.shape[2] // 8 * 8, planes.shape[3] // 8 * 8
    y = tk._lincomb(torch.from_numpy(planes[:, :, :h8, :w8]), 0).numpy().astype(np.float64)
    sums = [sum(int(v) for v in (frame * 2.0 ** 27).ravel()) for frame in y]
    return sums, np.array([float(Fraction(s, 2 ** 27 * h8 * w8)) for s in sums], np.float32)


@pytest.mark.parametrize("content", ["random", "black", "white", "one_dark_pixel"])
def test_y_dc_mean_reference_is_an_exact_sum(rng, content):
    planes = (rng.rand(3, 3, 67, 133) * 256).astype(np.uint8)
    if content != "random":
        planes[:] = 0 if content == "black" else 255
    if content == "one_dark_pixel":  # one black pixel in an all-255 batch
        planes[1, :, 40, 77] = 0
    sums, want = _exact_mean(planes)
    x = torch.from_numpy(planes)
    assert tk.y_fixed_sums(x).tolist() == sums
    got = tk.y_dc_mean_reference(x)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(tk.y_dc_mean(x), got)  # the wrapper's CPU path
    if content == "one_dark_pixel":
        assert got[1] < got[0] == got[2]


@pytest.mark.parametrize("h,w", SHAPES)
def test_y_dc_mean_matches_jax(rng, h, w):
    planes = natural_frames(rng, 2, h + 3, w + 5).transpose(0, 3, 1, 2).copy()
    want = np.asarray(jk._y_dc_mean(jnp.asarray(planes), h // 8 * 8, w // 8 * 8))
    got = tk.y_dc_mean_reference(torch.from_numpy(planes)).numpy()
    assert got.dtype == np.float32 and got.shape == (2,)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_plain_versions_take_the_interleaved_view(rng):
    """The frame batch's permuted view (the codec's input) gives the same
    result as contiguous planes, and marking writes a new tensor."""
    frames = natural_frames(rng, 2, 64, 128)
    view = torch.from_numpy(frames).permute(0, 3, 1, 2)
    wm2d = torch.from_numpy(_wm2d(64, 128))
    a = tk.fused_dct_qim_mark(view, wm2d, ALPHA)
    b = tk.fused_dct_qim_mark(view.contiguous(), wm2d, ALPHA)
    assert torch.equal(a, b) and a.stride() == view.stride()
    assert np.array_equal(view.numpy(), frames.transpose(0, 3, 1, 2))  # input untouched
    assert torch.equal(tk.fused_dct_qim_extract(a, ALPHA),
                       tk.fused_dct_qim_extract(a.contiguous(), ALPHA))


@pytest.mark.parametrize("bad", ["height", "width", "bits", "means", "dtype"])
def test_kernel_wrappers_reject_malformed_input(bad):
    planes = torch.zeros((2, 3, 16, 32), dtype=torch.uint8)
    wm2d, means = torch.zeros(2, 4), torch.zeros(2)
    with pytest.raises(ValueError):
        if bad == "height":
            tk.fused_dct_qim_extract(planes[:, :, :12], ALPHA)
        elif bad == "width":
            tk.fused_dct_qim_mark(planes[..., :28], wm2d[:, :3], ALPHA)
        elif bad == "bits":
            tk.fused_dct_qim_mark(planes, torch.zeros(4, 2), ALPHA)
        elif bad == "means":
            tk.fused_dct_qim_mark(planes, wm2d, ALPHA, means[:1])
        else:
            tk.y_dc_mean(planes.float())


# -- the codec -------------------------------------------------------------------------

@pytest.mark.parametrize("h,w", SHAPES)
def test_kernel_backend_on_cpu_follows_the_pallas_kernels(rng, h, w):
    """backend="kernel" walks the kernel branch (the plain versions on the
    CPU), which agrees with the XLA path within the Pallas kernels' bound."""
    frames = natural_frames(rng, 2, h, w)
    wm = spread_wm(h, w)
    kernels.reset_launch_counts()
    got = DctQim(backend="kernel").mark_frames(torch.from_numpy(frames), torch.from_numpy(wm))
    assert sum(kernels.launch_counts().values()) == 0
    planes = frames.transpose(0, 3, 1, 2).copy()
    want = np.asarray(jk.fused_dct_qim_mark(jnp.asarray(planes), jnp.asarray(_wm2d(h, w)),
                                            ALPHA, interpret=True)).transpose(0, 2, 3, 1)
    diff = np.abs(got.numpy().astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.98
    xla = _xla_marked(frames, wm)
    assert (np.abs(got.numpy().astype(int) - xla.astype(int)) <= 1).all()
    bits = DctQim(backend="kernel").extract_frames(got)
    assert bits.shape == (2, h * w // 64)
    np.testing.assert_array_equal(despread(bits.numpy()), np.tile(PAYLOAD, (2, 1)))


def test_dispatch_mirrors_the_reference():
    x8, x_odd = torch.zeros(1, 64, 128, 3), torch.zeros(1, 70, 128, 3)
    assert DctQim(backend="kernel")._use_kernel(x8)
    assert not DctQim(backend="kernel")._use_kernel(x_odd)  # H % 8: the tensor path
    assert not DctQim(backend="kernel", coeff_row=3)._use_kernel(x8)
    assert not DctQim()._use_kernel(x8)  # auto: kernels for CUDA tensors only
    assert not DctQim(backend="torch")._use_kernel(x8)
    with pytest.raises(ValueError):
        DctQim(backend="xla")


@pytest.mark.parametrize("backend,want", [("pallas", "kernel"), ("xla", "torch"), ("auto", "auto")])
def test_from_reference_round_trip(backend, want):
    ref = jwm.DctQim(alpha=25.0, coeff_row=3, coeff_col=2, backend=backend, fast_dots=True)
    c = DctQim.from_reference(ref)
    assert c == DctQim(alpha=25.0, coeff_row=3, coeff_col=2, backend=want)
    assert hash(c) == hash(DctQim(alpha=25, coeff_row=3, coeff_col=2, backend=want))
    assert (c.alpha, c.blk, c.coeff_row, c.coeff_col) == (ref.alpha, ref.blk, ref.coeff_row,
                                                          ref.coeff_col)
    assert c.wm_capacity((64, 128, 3)) == ref.wm_capacity((64, 128, 3))


def test_codecs_built_from_reference_agree(rng):
    frames = natural_frames(rng, 2, 64, 128)
    wm = spread_wm(64, 128)
    ref = jwm.DctQim(alpha=30.0, backend="xla")
    want = np.asarray(ref.mark_frames(jnp.asarray(frames), jnp.asarray(wm)))
    got = DctQim.from_reference(ref).mark_frames(torch.from_numpy(frames),
                                                 torch.from_numpy(wm)).numpy()
    assert (got == want).mean() >= 0.999


def test_make_codec_builds_dct_from_the_config():
    cfg = VfpConfig()
    cfg.codec.alpha_dct, cfg.codec.fast_dots = 27.0, True
    for name in ("dct", "dctqim", "dct_qim"):
        assert make_codec(name, cfg) == DctQim(alpha=27.0)
    jcfg = JaxConfig()
    jcfg.codec.alpha_dct = 27.0
    assert DctQim.from_reference(jcfg.make_codec("dct")) == make_codec("dct", cfg)


# -- pipeline and CLI ----------------------------------------------------------------

def test_multi_marker_marks_two_dct_variants(rng):
    frames = natural_frames(rng, 3, 64, 128)
    wms = [spread_wm(64, 128, payload=PAYLOAD), spread_wm(64, 128, payload=1 - PAYLOAD)]
    want = jpipe.MultiMarker(jwm.DctQim(backend="xla"), wms, batch_size=4).mark_all(frames)
    mm = tpipe.MultiMarker(DctQim(), wms, batch_size=4, device="cpu")
    got = mm.mark_all(frames)
    assert mm.n_variants == 2 and got.shape == want.shape == (2, 3, 64, 128, 3)
    assert (got == want).mean() >= 0.999
    bits = [DctQim().extract_frames(torch.from_numpy(v.copy())).numpy() for v in got]
    np.testing.assert_array_equal(despread(bits[0]), np.tile(PAYLOAD, (3, 1)))
    np.testing.assert_array_equal(despread(bits[1]), np.tile(1 - PAYLOAD, (3, 1)))


def _read(path):
    r = RawVideoReader(path)
    try:
        return r.read_batch(1000)
    finally:
        r.close()


def test_cli_dct_matches_the_jax_cli(rng, tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("VFP_LOWLINK", "0")
    src, jax_out, port_out = (tmp_path / n for n in ("src.rawv", "jax.rawv", "port.rawv"))
    with RawVideoWriter(src, 128, 64, fps=6) as w:
        w.write_batch(natural_frames(rng, 6, 64, 128))
    jax_cli(["mark", str(src), str(jax_out), "--codec", "dct", "--batch-size", "4"])
    port_cli(["mark", str(src), str(port_out), "--codec", "dct", "--batch-size", "4",
              "--device", "cpu"])
    assert "marked 6 frames" in capsys.readouterr().out
    a, b = _read(jax_out), _read(port_out)
    assert a.shape == b.shape == (6, 64, 128, 3)
    assert (a == b).mean() >= 0.999

    jax_cli(["detect", str(jax_out), "--codec", "dct", "--payload", "01100101",
             "--batch-size", "4"])
    jax_lines = capsys.readouterr().out
    port_cli(["detect", str(port_out), "--codec", "dct", "--payload", "01100101",
              "--batch-size", "4", "--device", "cpu", "--fast-dots"])
    port_lines = capsys.readouterr().out
    for line in ("majority payload: 01100101 (frequency 1.00)", "matches expected payload: True"):
        assert line in jax_lines and line in port_lines
