"""The DT-CWT key codec's detect path in vfp_tpu_torch against vfp_tpu, on the CPU.

The same numpy inputs go through the JAX function and its port.  The JAX
codec is built with ``fast_dots=False`` and its Pallas kernels run in
interpret mode with ``fast=False`` (the default bf16 passes round the
operands).  The port's kernel wrappers take their plain versions here (CPU
tensors).  Stated tolerances:

- ``dtcwt_level1_ll_color``'s plain version against the Pallas kernel
  ``dtcwt_level1_analysis_ll_color`` and the valid window of its chained twin:
  atol 2e-4 on 0-255 data (float32 sums in another order);
- ``dtcwt_qshift_ll`` / ``dtcwt_qshift_hp`` against
  ``dtcwt_qshift_analysis_ll`` / ``_hp``: atol 2e-5 on [0, 1] data; the
  whole chain from u8 frames (``ll_color_chain -> qshift_ll_chain ->
  qshift_hp_chain``) atol 2e-4 (0-255 data), and the masks of its Y half
  equal;
- ``dtcwt_legall_synthesis_hp`` against its Pallas kernel: atol 2e-5;
- the codec's kernel path against the JAX codec's XLA decode run op by op
  (``_decode_channel_raw``) and against the Pallas chain the TPU runs:
  planes atol 1e-4, correlations atol 1e-5.  Against the jitted
  ``JAX_CODEC.extract_frames``: >= 99.5% of plane values within 1e-4 and
  correlations within 1e-3, because XLA's fused CPU program rounds its own
  masks otherwise than its op-by-op run: at 480x856 (seed 1234) one mask
  value lands on the other side of a ceil, and 24 of 12,960 plane values
  move by up to 0.006 there, in JAX's own two runs alike.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfp_tpu.kernels import dtcwt_level1 as jl1, dtcwt_masks as jmasks
from vfp_tpu.kernels import dtcwt_synthesis as jsyn
from vfp_tpu.ops.color import bgr_to_yuv as jax_bgr_to_yuv
from vfp_tpu.wm import dtcwt_codecs as jcodecs, payload_img as jpimg
from vfp_tpu_torch import kernels
from vfp_tpu_torch.kernels import dtcwt_level1 as tl1, dtcwt_masks as tmasks
from vfp_tpu_torch.kernels import dtcwt_synthesis as tsyn
from vfp_tpu_torch.ops import dtcwt as tdt
from vfp_tpu_torch.wm import CorrShuffler, DeCorrShuffler, DtcwtKey

from test_dwt_dct_svd import natural_frames as smooth_frames
from test_torch_dtcwt import LL_U8_CASES, jax_level1_ll, ll_u8_ids
from torch_parity import natural_frames

torch.set_num_threads(1)
JAX_CODEC = jcodecs.DtcwtKey(fast_dots=False)


def _np(x):
    return np.asarray(x)


def _frames(rng, h, w):
    return rng.randint(0, 256, (2, h, w, 3)).astype(np.uint8)


# -- the kernels' plain versions against the Pallas kernels ------------------------------

@pytest.mark.parametrize("b,h,w", LL_U8_CASES, ids=ll_u8_ids(LL_U8_CASES))
def test_level1_ll_color_matches_pallas(rng, b, h, w):
    f = rng.randint(0, 256, (b, h, w, 3)).astype(np.uint8)
    got = tl1.dtcwt_level1_ll_color(torch.from_numpy(f)).numpy()
    assert got.shape == (b, 2, 4, h // 2, w // 2)
    want = jax_level1_ll(f, 2, jl1.dtcwt_level1_analysis_ll_color)
    np.testing.assert_allclose(got, want, atol=2e-4)
    if jl1.chain_eligible(h, w):  # the chained twin's valid window
        m = jl1.CHAIN_MARGIN // 2
        raw = _np(jl1.dtcwt_level1_ll_color_chain(jnp.asarray(f), interpret=True))
        np.testing.assert_allclose(got, raw[..., m: m + h // 2, m: m + w // 2], atol=2e-4)


@pytest.mark.parametrize("shape", [(2, 4, 32, 64), (2, 4, 34, 96)])
@pytest.mark.parametrize("port,pallas", [
    (tl1.dtcwt_qshift_ll, jl1.dtcwt_qshift_analysis_ll),
    (tl1.dtcwt_qshift_hp, jl1.dtcwt_qshift_analysis_hp),
], ids=["ll", "hp"])
def test_qshift_level_matches_pallas(rng, shape, port, pallas):
    assert jl1.kernel_eligible(*shape[2:])
    x = rng.rand(*shape).astype(np.float32)
    got = port(torch.from_numpy(x)).numpy()
    want = _np(pallas(jnp.asarray(x), interpret=True, fast=False))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_detect_analysis_matches_the_pallas_chain(rng):
    """u8 frames -> level 1 (Y and U) -> U level 2 (lowpasses) -> U level 3
    (highpasses), and the Y masks: the port's kernels on the valid sizes
    against the chain the TPU runs on the padded layout."""
    h, w = 128, 256
    assert jl1.chain_eligible(h, w)
    f = _frames(rng, h, w)
    raw = jl1.dtcwt_level1_ll_color_chain(jnp.asarray(f), interpret=True, fast=False)
    u_ll2 = jl1.dtcwt_qshift_ll_chain(raw[:, 1], interpret=True, fast=False)
    want = _np(jl1.dtcwt_qshift_hp_chain(u_ll2, (h // 8, w // 8), interpret=True, fast=False))
    ll = tl1.dtcwt_level1_ll_color(torch.from_numpy(f))
    got = tl1.dtcwt_qshift_hp(tl1.dtcwt_qshift_ll(ll[:, 1])).numpy()
    assert got.shape == want.shape == (2, 12, h // 8, w // 8)
    np.testing.assert_allclose(got, want, atol=2e-4)
    masks = _np(jmasks.dtcwt_qshift_masks_chain(raw[:, 0], (h // 8, w // 8), step=5.0,
                                                interpret=True, fast=False))
    np.testing.assert_array_equal(tmasks.dtcwt_qshift_masks(ll[:, 0], 5.0).numpy(), masks)


@pytest.mark.parametrize("h,w", [(32, 64), (68, 120)])  # (68, 120): 1080p's folded planes
def test_legall_synthesis_hp_matches_pallas(rng, h, w):
    d = rng.randn(2, 12, h, w).astype(np.float32)
    got = tsyn.dtcwt_legall_synthesis_hp(torch.from_numpy(d)).numpy()
    assert got.shape == (2, 2 * h, 2 * w)
    want = _np(jsyn.dtcwt_legall_synthesis_hp(jnp.asarray(d), interpret=True, fast=False))
    np.testing.assert_allclose(got, want, atol=2e-5)


# -- the codec ---------------------------------------------------------------------------

def _marked(rng, h, w, key=3, frames=natural_frames):
    f = torch.from_numpy(frames(rng, b=2, h=h, w=w))
    wm = torch.as_tensor(CorrShuffler(key).generate_wm(None, DtcwtKey().wm_capacity((h, w, 3))))
    return DtcwtKey(backend="kernel").mark_frames(f, wm)


@pytest.mark.parametrize("h,w", [(128, 256), (480, 856)])
def test_kernel_path_extracts_as_jax(rng, h, w):
    marked = _marked(rng, h, w)
    kernels.reset_launch_counts()
    got = DtcwtKey(backend="kernel").extract_frames(marked)
    assert not any(kernels.launch_counts().values())  # plain versions on the CPU
    yuv = jax_bgr_to_yuv(jnp.asarray(marked.numpy(), jnp.float32))
    want = _np(JAX_CODEC._decode_channel_raw(yuv[..., 0], yuv[..., 1]))
    assert got.shape == want.shape == (2, *DtcwtKey().wm_capacity((h, w, 3)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), DtcwtKey(backend="torch").extract_frames(marked),
                               atol=1e-4)
    jitted = _np(JAX_CODEC.extract_frames(jnp.asarray(marked.numpy())))
    assert (np.abs(got.numpy() - jitted) <= 1e-4).mean() >= 0.995
    deg, jdeg = DeCorrShuffler(3), jpimg.DeCorrShuffler(3)
    np.testing.assert_allclose(deg.correlation_batch(got).numpy(),
                               _np(jdeg.correlation_batch(jnp.asarray(jitted))), atol=1e-3)


def test_kernel_path_extracts_as_the_pallas_chain(rng):
    h, w = 128, 256
    marked = _marked(rng, h, w)
    raw = jl1.dtcwt_level1_ll_color_chain(jnp.asarray(marked.numpy()), interpret=True)
    want = _np(JAX_CODEC._decode_from_ll1_chain(raw[:, 0], raw[:, 1], (h, w), True))
    got = DtcwtKey(backend="kernel").extract_frames(marked)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    for key in (3, 99):
        np.testing.assert_allclose(DeCorrShuffler(key).correlation_batch(got).numpy(),
                                   _np(jpimg.DeCorrShuffler(key).correlation_batch(
                                       jnp.asarray(want))), atol=1e-5)


def test_kernel_path_finds_the_key_it_marked(rng):
    marked = _marked(rng, 240, 320, frames=smooth_frames)  # the content tests/test_dtcwt.py marks
    planes = DtcwtKey(backend="kernel").extract_frames(marked)
    assert bool((DeCorrShuffler(3).correlation_batch(planes) > 0.1).all())
    assert bool((DeCorrShuffler(99).correlation_batch(planes) < 0.1).all())


# -- Transform2d's kernel routing ----------------------------------------------------------

@pytest.mark.parametrize("block,module,wrapper,shape", [
    (lambda t, x: t.analysis_qshift(x, lowpass_only=True)[0], tl1, "dtcwt_qshift_ll",
     (2, 3, 4, 16, 32)),
    (lambda t, x: t.analysis_qshift_hp(x)[0], tl1, "dtcwt_qshift_hp", (2, 3, 4, 16, 32)),
    (lambda t, x: t.synthesis_legall_hp(x), tsyn, "dtcwt_legall_synthesis_hp", (2, 3, 12, 8, 16)),
], ids=["qshift_ll", "qshift_hp", "legall_synthesis_hp"])
def test_kernel_mode_routes_the_detect_blocks(rng, monkeypatch, block, module, wrapper, shape):
    calls = []
    fn = getattr(module, wrapper)
    monkeypatch.setattr(module, wrapper, lambda x: calls.append(x.shape) or fn(x))
    x = torch.from_numpy(rng.rand(*shape).astype(np.float32))
    kernels.reset_launch_counts()
    got = block(tdt.Transform2d("kernel"), x)
    assert calls == [(shape[0] * shape[1], *shape[2:])]  # one call over the flattened lead axes
    assert not any(kernels.launch_counts().values())
    assert torch.equal(got, block(tdt.Transform2d("torch"), x))


UNPORTED_BLOCKS = {  # id: (block, [(module, wrapper, the shape of its one call)])
    "level1_lowpass": (lambda t, x: t.analysis_level1(x[:, :, 0], lowpass_only=True)[0],
                       [(tl1, "dtcwt_level1_analysis_ll", (6, 16, 32))]),
    "qshift_full": (lambda t, x: t.analysis_qshift(x)[0],
                    [(tl1, "dtcwt_qshift_analysis", (6, 4, 16, 32))]),
    "synthesis_qshift": (lambda t, x: t.synthesis_qshift(torch.cat([x, x, x, x], dim=2)),
                         [(tsyn, "dtcwt_qshift_synthesis", (6, 16, 16, 32))]),
    "synthesis_qshift_ll": (lambda t, x: t.synthesis_qshift_ll(x),
                            [(tsyn, "dtcwt_qshift_synthesis_ll", (6, 4, 16, 32))]),
    "synthesis_legall_ll": (lambda t, x: t.synthesis_legall_ll(x),
                            [(tsyn, "dtcwt_legall_synthesis_ll", (6, 4, 16, 32))]),
    "forward_2_levels": (lambda t, x: t.forward(x[:, :, 0], nlevels=2),
                         [(tl1, "dtcwt_level1_analysis", (6, 16, 32)),
                          (tl1, "dtcwt_qshift_analysis", (6, 4, 8, 16))]),
    "inverse": (lambda t, x: t.inverse(tdt.Transform2d("torch").forward(x[:, :, 0], nlevels=2)),
                [(tsyn, "dtcwt_qshift_synthesis", (6, 16, 4, 8)),
                 (tsyn, "dtcwt_legall_synthesis", (6, 16, 8, 16))]),
}


def _tensors(out):
    if isinstance(out, tdt.Pyramid):
        return [out.lowpass, *out.highpasses]
    return [out]


@pytest.mark.parametrize("case", list(UNPORTED_BLOCKS))
def test_kernel_mode_still_raises_for_unported_blocks(rng, monkeypatch, case):
    """Named for the blocks that raised before their kernels were ported:
    each now calls its wrapper(s) once over the flattened lead axes, runs
    the plain version on the CPU without a launch, and equals the plain
    transform."""
    block, wrappers = UNPORTED_BLOCKS[case]
    calls = []
    for module, name, _ in wrappers:
        fn = getattr(module, name)
        monkeypatch.setattr(module, name,
                            lambda x, _fn=fn, _name=name: calls.append((_name, x.shape)) or _fn(x))
    x = torch.from_numpy(rng.rand(2, 3, 4, 16, 32).astype(np.float32))
    kernels.reset_launch_counts()
    got = block(tdt.Transform2d("kernel"), x)
    assert calls == [(name, shape) for _, name, shape in wrappers]
    assert not any(kernels.launch_counts().values())
    want = block(tdt.Transform2d("torch"), x)
    assert all(torch.equal(a, b) for a, b in zip(_tensors(got), _tensors(want), strict=True))
