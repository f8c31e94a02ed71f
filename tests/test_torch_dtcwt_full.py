"""The whole DT-CWT of vfp_tpu_torch against vfp_tpu, on the CPU: the plain
versions of the six full-transform kernels and of the highpass-only LeGall
synthesis, ``Transform2d`` at 1-4 levels, and the ``DtcwtKey`` codec off the
fused geometry (H or W not a multiple of 8, odd frames, float frames, other
depths).

The same numpy inputs go through the JAX function and its port.  The JAX
Pallas kernels run in interpret mode with ``fast=False``; the JAX codec is
built with ``fast_dots=False`` (its default bf16 passes move masks).  The
port's wrappers take their plain versions here (CPU tensors), so the routing
tests spy on which wrappers a path calls.  Stated tolerances:

- each plain version against its Pallas kernel (or, for LeGall planes the
  Pallas kernel does not take, smaller than 32 x 64, the JAX XLA chain):
  atol 2e-5 on [0, 1) data (float32 sums in another order);
- ``Transform2d("kernel")`` against ``Transform2d(backend="xla")``: atol 2e-5
  on [0, 1) data;
- the codec against the JAX codec: >= 99.9% of marked pixels identical and
  the rest within 2 (a mask value on a ceil edge may take the other step,
  ROADMAP.md section 3); the recovered planes within 1e-4 of the JAX
  codec's decode run op by op, and the correlations within 0.01 of its
  jitted extract.

The JAX codec refuses frames whose level-2 grid has an odd width
(``rebin_mean`` zero-pads an odd height only): W = 2, 3 or 4 mod 8, as in
63x129, 201x330 or 236x324; so does the port.  The frames here have W = 0,
5 or 6 mod 8: 68x192, 236x318 (H and W not multiples of 8), 63x128 and
239x317 (odd).
"""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfp_tpu.cli.__main__ import main as jax_cli
from vfp_tpu.kernels import dtcwt_level1 as jl1, dtcwt_synthesis as jsyn
from vfp_tpu.ops import dtcwt as jdt
from vfp_tpu.ops.color import bgr_to_yuv as jax_bgr_to_yuv
from vfp_tpu.wm import dtcwt_codecs as jcodecs, payload_img as jpimg
from vfp_tpu_torch import kernels
from vfp_tpu_torch.cli import main as port_cli
from vfp_tpu_torch.io import RawVideoReader, RawVideoWriter
from vfp_tpu_torch.kernels import dtcwt_delta as tdelta, dtcwt_level1 as tl1
from vfp_tpu_torch.kernels import dtcwt_masks as tmasks, dtcwt_synthesis as tsyn
from vfp_tpu_torch.ops import color as tcolor, dtcwt as tdt
from vfp_tpu_torch.wm import DeCorrShuffler, DtcwtKey, dtcwt_codecs as tcodecs

from torch_parity import natural_frames

torch.set_num_threads(1)


def _np(x):
    return np.asarray(x)


# -- the plain versions against the Pallas kernels ----------------------------------------

PALLAS = {
    "dtcwt_level1_analysis_ll": (tl1, jl1.dtcwt_level1_analysis_ll),
    "dtcwt_qshift_analysis": (tl1, jl1.dtcwt_qshift_analysis),
    "dtcwt_qshift_synthesis": (tsyn, jsyn.dtcwt_qshift_synthesis),
    "dtcwt_qshift_synthesis_ll": (tsyn, jsyn.dtcwt_qshift_synthesis_ll),
    "dtcwt_legall_synthesis": (tsyn, jsyn.dtcwt_legall_synthesis),
    "dtcwt_legall_synthesis_ll": (tsyn, jsyn.dtcwt_legall_synthesis_ll),
    "dtcwt_legall_synthesis_hp": (tsyn, jsyn.dtcwt_legall_synthesis_hp),
}
# the JAX XLA chain of each synthesis and of level 1, for planes the Pallas
# kernel does not take (synthesis_eligible: h >= 32 and w >= 64;
# kernel_eligible: H >= 32 and W >= 64 with a wrap pad that fits)
XLA_CHAIN = {
    "dtcwt_level1_analysis_ll":
        lambda x: jdt.Transform2d(backend="xla").analysis_level1(x, lowpass_only=True)[0],
    "dtcwt_legall_synthesis": lambda x: jdt.Transform2d(backend="xla").inverse_raw([x]),
    "dtcwt_legall_synthesis_ll": lambda x: jdt.Transform2d(backend="xla").synthesis_legall_ll(x),
    "dtcwt_legall_synthesis_hp": lambda x: jdt.Transform2d(backend="xla").synthesis_legall_hp(x),
    "dtcwt_qshift_synthesis": lambda x: jdt.Transform2d(backend="xla").synthesis_qshift(x),
    "dtcwt_qshift_synthesis_ll": lambda x: jdt.Transform2d(backend="xla").synthesis_qshift_ll(x),
}
ELIGIBLE = {"dtcwt_level1_analysis_ll": jl1.kernel_eligible}  # else synthesis_eligible
LEGALL_PLANES = {"dtcwt_legall_synthesis": 16, "dtcwt_legall_synthesis_ll": 4,
                 "dtcwt_legall_synthesis_hp": 12}
QSHIFT_PLANES = {"dtcwt_qshift_synthesis": 16, "dtcwt_qshift_synthesis_ll": 4}
PALLAS_CASES = [
    ("dtcwt_level1_analysis_ll", (2, 64, 128)), ("dtcwt_level1_analysis_ll", (2, 136, 240)),
    ("dtcwt_qshift_analysis", (2, 4, 32, 64)), ("dtcwt_qshift_analysis", (2, 4, 34, 96)),
    ("dtcwt_qshift_synthesis", (2, 16, 32, 64)), ("dtcwt_qshift_synthesis", (2, 16, 68, 120)),
    ("dtcwt_qshift_synthesis_ll", (2, 4, 32, 64)), ("dtcwt_qshift_synthesis_ll", (2, 4, 68, 120)),
    ("dtcwt_legall_synthesis", (2, 16, 32, 64)), ("dtcwt_legall_synthesis", (2, 16, 68, 120)),
    ("dtcwt_legall_synthesis_ll", (2, 4, 32, 64)), ("dtcwt_legall_synthesis_ll", (2, 4, 68, 120)),
] + [  # the LeGall tile's edges (32 x 64 outputs, a 19 x 35 input window): planes
    # smaller than the window (1x1, 1x2, 3x5), odd h and w (2w % 4 != 0), B = 1
    # and 32, one tile exactly, and a ragged last tile
    (name, (b, LEGALL_PLANES[name], h, w)) for name in LEGALL_PLANES
    for b, h, w in ((2, 1, 1), (1, 1, 2), (2, 3, 5), (1, 17, 33), (32, 16, 32), (1, 33, 65))
] + [  # the level-1 lowpass tile's edges (8 x 32 positions, a 20 x 68 input
    # window): frames smaller than the window, h1 % 8 and w1 % 32 != 0, W % 4
    # == 2 (odd w1), B = 1 and 32, and the padded 854x480 frame
    ("dtcwt_level1_analysis_ll", shape)
    for shape in ((1, 2, 2), (1, 6, 10), (2, 34, 98), (1, 38, 70), (32, 32, 64), (32, 6, 10),
                  (1, 480, 854))
] + [  # the q-shift synthesis tile's edges (32 x 64 outputs, a 23 x 39 input
    # window): planes smaller than the 7-sample halo, odd h and w, B = 1 and
    # 32, one tile exactly, a ragged last tile, and a plane the Pallas kernel takes
    (name, (b, QSHIFT_PLANES[name], h, w)) for name in QSHIFT_PLANES
    for b, h, w in ((2, 1, 1), (1, 1, 2), (2, 3, 5), (1, 17, 33), (32, 16, 32), (1, 33, 65),
                    (1, 33, 66))
]


@pytest.mark.parametrize("name,shape", PALLAS_CASES,
                         ids=[f"{n[6:]}-{'x'.join(map(str, s))}" for n, s in PALLAS_CASES])
def test_plain_version_matches_pallas(rng, name, shape):
    """Against the Pallas kernel in interpret mode where it takes the shape,
    else against the JAX XLA chain."""
    module, pallas = PALLAS[name]
    x = rng.rand(*shape).astype(np.float32)
    kernels.reset_launch_counts()
    got = getattr(module, name)(torch.from_numpy(x)).numpy()
    assert not any(kernels.launch_counts().values())
    if name in XLA_CHAIN and not ELIGIBLE.get(name, jsyn.synthesis_eligible)(*shape[-2:]):
        want = _np(XLA_CHAIN[name](jnp.asarray(x)))
    else:
        want = _np(pallas(jnp.asarray(x), interpret=True, fast=False))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.mark.parametrize("shape", [(2, 64, 128), (1, 38, 70)])
def test_level1_lowpass_reads_the_y_view_as_its_copy(rng, shape):
    """The codec's float-frame mark path hands ``dtcwt_level1_analysis_ll``
    the Y channel of ``bgr_to_yuv`` (pixels 3 floats apart), which the CUDA
    wrapper reads in place: the result equals the wrapper's on the
    contiguous copy and the JAX function's on the same Y."""
    frames = rng.rand(*shape, 3).astype(np.float32)
    yuv = tcolor.bgr_to_yuv(torch.from_numpy(frames))
    view = yuv[..., 0]
    assert not view.is_contiguous() and view.stride(-1) == 3
    kernels.reset_launch_counts()
    got = tl1.dtcwt_level1_analysis_ll(view)
    assert not any(kernels.launch_counts().values())
    assert torch.equal(got, tl1.dtcwt_level1_analysis_ll(view.contiguous()))
    want = jl1.dtcwt_level1_analysis_ll(jax_bgr_to_yuv(jnp.asarray(frames))[..., 0],
                                        interpret=True, fast=False)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=2e-5)


# -- Transform2d at any depth ----------------------------------------------------------

@pytest.mark.parametrize("nlevels", [1, 2, 3, 4])
@pytest.mark.parametrize("shape", [(64, 96), (66, 98), (62, 130)])
def test_transform_matches_jax(rng, shape, nlevels):
    """forward / inverse / forward_raw / inverse_raw on the kernel backend
    (the wrappers' plain versions here) against the JAX XLA transform."""
    jt, tt = jdt.Transform2d(backend="xla"), tdt.Transform2d("kernel")
    x = rng.rand(2, *shape).astype(np.float32)
    kernels.reset_launch_counts()
    got, want = tt.forward(torch.from_numpy(x), nlevels), jt.forward(jnp.asarray(x), nlevels)
    assert got.sizes == [tuple(s) for s in want._sizes]
    np.testing.assert_allclose(got.lowpass.numpy(), _np(want.lowpass), atol=2e-5)
    for g, w in zip(got.highpasses, want.highpasses, strict=True):
        np.testing.assert_allclose(g.numpy(), _np(w), atol=2e-5)
    rec = tt.inverse(got).numpy()
    np.testing.assert_allclose(rec, _np(jt.inverse(want)), atol=2e-5)
    np.testing.assert_allclose(rec, x, atol=2e-5)
    planes, sizes = tt.forward_raw(torch.from_numpy(x), nlevels)
    jplanes, jsizes = jt.forward_raw(jnp.asarray(x), nlevels)
    assert sizes == [tuple(s) for s in jsizes]
    for g, w in zip(planes, jplanes, strict=True):
        np.testing.assert_allclose(g.numpy(), _np(w), atol=2e-5)
    got_inv = tt.inverse_raw([torch.from_numpy(np.array(p)) for p in jplanes], jsizes)
    np.testing.assert_allclose(got_inv.numpy(), _np(jt.inverse_raw(jplanes, jsizes)), atol=2e-5)
    assert not any(kernels.launch_counts().values())


# -- the codec ---------------------------------------------------------------------------

DTCWT_WRAPPERS = {
    tl1: ("dtcwt_level1_ll_y", "dtcwt_level1_ll_color", "dtcwt_level1_analysis",
          "dtcwt_level1_analysis_ll", "dtcwt_qshift_ll", "dtcwt_qshift_hp",
          "dtcwt_qshift_analysis"),
    tmasks: ("dtcwt_qshift_masks",),
    tdelta: ("dtcwt_delta_synthesis",),
    tsyn: ("dtcwt_qshift_synthesis", "dtcwt_qshift_synthesis_ll", "dtcwt_legall_synthesis",
           "dtcwt_legall_synthesis_ll", "dtcwt_legall_synthesis_hp"),
}


def _spy_wrappers(monkeypatch) -> collections.Counter:
    """Count the calls of every DT-CWT wrapper, wherever the codec or
    ``Transform2d`` looks it up."""
    calls = collections.Counter()
    for module, names in DTCWT_WRAPPERS.items():
        for name in names:
            def spy(*args, _fn=getattr(module, name), _name=name):
                calls[_name] += 1
                return _fn(*args)

            monkeypatch.setattr(module, name, spy)
            if hasattr(tcodecs, name):
                monkeypatch.setattr(tcodecs, name, spy)
    return calls


def _mark_and_extract_as_jax(rng, monkeypatch, h, w, *, nlevels=3, dtype=np.uint8):
    """The port's kernel backend against the JAX codec on the same frames:
    marks, then the planes of the JAX-marked frames; returns the port's
    wrapper calls."""
    jax_codec = jcodecs.DtcwtKey(nlevels=nlevels, fast_dots=False)
    f = natural_frames(rng, 2, h, w).astype(dtype)
    wm = jpimg.CorrShuffler(3).generate_wm(None, jax_codec.wm_capacity((h, w, 3)))
    want = _np(jax_codec.mark_frames(jnp.asarray(f), jnp.asarray(wm)))
    codec = DtcwtKey(nlevels=nlevels, backend="kernel")
    calls = _spy_wrappers(monkeypatch)
    tcodecs.clear_wm_cache()  # the spectrum is computed once per distinct plane
    kernels.reset_launch_counts()
    got = codec.mark_frames(torch.from_numpy(f), torch.from_numpy(wm)).numpy()
    assert got.dtype == np.uint8 and got.shape == f.shape
    d = np.abs(got.astype(int) - want)
    assert (d == 0).mean() >= 0.999 and d.max() <= 2, ((d == 0).mean(), d.max())
    marked = want.astype(dtype)
    planes = codec.extract_frames(torch.from_numpy(marked))
    assert not any(kernels.launch_counts().values())  # plain versions on the CPU
    yuv = jax_bgr_to_yuv(jnp.asarray(marked, jnp.float32))
    op_by_op = _np(jax_codec._decode_channel_raw(yuv[..., 0], yuv[..., 1]))
    assert planes.shape == op_by_op.shape
    assert nlevels != 3 or planes.shape == (2, *codec.wm_capacity((h, w, 3)))
    np.testing.assert_allclose(planes.numpy(), op_by_op, atol=1e-4)
    jitted = jax_codec.extract_frames(jnp.asarray(marked))
    for key in (3, 99):
        np.testing.assert_allclose(
            DeCorrShuffler(key).correlation_batch(planes).numpy(),
            _np(jpimg.DeCorrShuffler(key).correlation_batch(jitted)), atol=0.01)
    return calls


@pytest.mark.parametrize("h,w", [(68, 192), (236, 318)])
def test_uint8_frames_without_exact_levels_as_jax(rng, monkeypatch, h, w):
    """Even frames with H or W % 8 != 0: the color-fused level-1 kernels,
    then the mask glue and the three-stage synthesis instead of the fused
    masks and delta kernels."""
    calls = _mark_and_extract_as_jax(rng, monkeypatch, h, w)
    assert calls["dtcwt_level1_ll_y"] == calls["dtcwt_level1_ll_color"] == 1, calls
    for name in ("dtcwt_qshift_synthesis", "dtcwt_qshift_synthesis_ll",
                 "dtcwt_legall_synthesis_ll", "dtcwt_qshift_ll", "dtcwt_legall_synthesis_hp"):
        assert calls[name] == 1, (name, calls)
    assert calls["dtcwt_qshift_hp"] == 3, calls  # mark: Y level 2; detect: U level 3, Y level 2
    assert not calls["dtcwt_qshift_masks"] and not calls["dtcwt_delta_synthesis"], calls


@pytest.mark.parametrize("h,w", [(63, 128), (239, 317)])
def test_odd_frames_as_jax(rng, monkeypatch, h, w):
    """Odd H (or W): the bgr_to_yuv channel path, level 1 lowpass-only on
    the replicate-padded frame."""
    calls = _mark_and_extract_as_jax(rng, monkeypatch, h, w)
    assert calls["dtcwt_level1_analysis_ll"] == 2, calls  # mark: Y; detect: [Y; U]
    assert not calls["dtcwt_level1_ll_y"] and not calls["dtcwt_level1_ll_color"], calls


def test_float_frames_mark_and_extract_as_jax(rng, monkeypatch):
    """Float frames of integer values take the bgr_to_yuv path, as the JAX
    codec routes them, and at 64x128 the fused masks and delta kernels."""
    calls = _mark_and_extract_as_jax(rng, monkeypatch, 64, 128, dtype=np.float32)
    assert calls["dtcwt_level1_analysis_ll"] == 2, calls
    assert calls["dtcwt_qshift_masks"] == 2 and calls["dtcwt_delta_synthesis"] == 1, calls
    assert not calls["dtcwt_level1_ll_y"] and not calls["dtcwt_qshift_synthesis"], calls


@pytest.mark.parametrize("nlevels", [2, 4])
def test_other_depths_as_jax(rng, monkeypatch, nlevels):
    """nlevels != 3: the full raw pyramid of [Y; U] and U's inverse.  The
    JAX codec detects its own mark only at 3 levels, so only equality with
    it is held, not detection; at 4 levels it takes only frames whose level
    2 rebins onto level 4 (H, W % 16 == 0 for even frames, not 1080 rows)."""
    calls = _mark_and_extract_as_jax(rng, monkeypatch, 128, 256, nlevels=nlevels)
    # mark: the watermark plane (the cache was cleared) and [Y; U]; detect: [Y; U]
    assert calls["dtcwt_level1_analysis"] == 3, calls
    assert calls["dtcwt_qshift_analysis"] == 2 * (nlevels - 1), calls
    assert calls["dtcwt_qshift_synthesis"] == nlevels - 1, calls
    assert calls["dtcwt_legall_synthesis"] == 1 and calls["dtcwt_legall_synthesis_hp"] == 1
    assert not calls["dtcwt_level1_ll_y"] and not calls["dtcwt_qshift_masks"], calls


def _read(path):
    r = RawVideoReader(path)
    try:
        return r.read_batch(1000)
    finally:
        r.close()


def test_cli_dtcwt_key_round_trip_off_the_fused_geometry_matches_the_jax_cli(
        rng, tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("VFP_LOWLINK", "0")
    h, w = 236, 318
    src, jax_out, port_out = (tmp_path / n for n in ("src.rawv", "jax.rawv", "port.rawv"))
    with RawVideoWriter(src, w, h, fps=6) as wr:
        wr.write_batch(natural_frames(rng, 4, h, w))
    jax_cli(["mark", str(src), str(jax_out), "--codec", "dtcwtKey", "--batch-size", "2"])
    port_cli(["mark", str(src), str(port_out), "--codec", "dtcwtKey", "--batch-size", "2",
              "--device", "cpu"])
    assert "marked 4 frames" in capsys.readouterr().out
    a, b = _read(jax_out), _read(port_out)
    assert a.shape == b.shape == (4, h, w, 3)
    assert (a == b).mean() >= 0.999
    for key, present in ((0, "4/4"), (99, "0/4")):
        jax_cli(["detect", str(jax_out), "--codec", "dtcwtKey", "--key", str(key)])
        jax_lines = capsys.readouterr().out
        port_cli(["detect", str(port_out), "--codec", "dtcwtKey", "--key", str(key),
                  "--device", "cpu"])
        port_lines = capsys.readouterr().out
        for lines in (jax_lines, port_lines):
            assert "frames: 4" in lines and f"watermark present in {present} frames" in lines
