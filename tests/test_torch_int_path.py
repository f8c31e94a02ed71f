"""The flagship kernels' integer bodies (``int_path=True``) and the last
public names of the JAX package, on the CPU, against ``vfp_tpu``.

The Pallas kernels run in interpret mode with ``int_path=True``, as
``tests/test_kernels.py::TestIntPath`` runs them.  Stated tolerances, those
of the float32 bodies (``tests/test_torch_kernels.py``) and of the JAX
int-path test: marked u8 identical to the Pallas int body on >= 99.5% of
pixels with the payload recovered, decoded bits identical on >= 99.9% of
blocks (a borderline s0 may take the other, parity-equivalent QIM bin);
rows past the block grid equal to the input; the int body against the
float32 body identical on >= 98% of pixels (``tests/test_kernels.py:409``).
The Jacobi triplet against the JAX SoA Jacobi: s0 rtol 2e-5 and the rank-1
action u vᵀ atol 2e-5, the tolerance of the power-method triplet's test
(one float32 rotation order, sums reduced in another order).  The native
pipes: bytes equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfp_tpu import pipeline as jpipe
from vfp_tpu.kernels import fused_embed as jfe
from vfp_tpu.native import NativePipeReader as JaxPipeReader, NativePipeWriter as JaxPipeWriter
from vfp_tpu.ops import color as jcolor, soa as jsoa
from vfp_tpu.utils import VfpConfig as JaxConfig
from vfp_tpu.wm import DeShuffler as JaxDeShuffler, DwtDctSvd as JaxCodec
from vfp_tpu.wm.dwt_dct_svd import block_grid
from vfp_tpu_torch import pipeline as tpipe
from vfp_tpu_torch.kernels import fused_embed as tfe
from vfp_tpu_torch.native import NativePipeReader, NativePipeWriter
from vfp_tpu_torch.ops import soa as tsoa
from vfp_tpu_torch.pipeline.extractor import cached_bit_extractor
from vfp_tpu_torch.utils import VfpConfig, make_codec
from vfp_tpu_torch.utils.config import CodecConfig
from vfp_tpu_torch.wm import DeShuffler, DwtDctSvd

from test_torch_kernels import FUSED_MARK_CASES, FUSED_SHAPES, _case_ids
from torch_parity import PAYLOAD, despread, natural_frames, spread_wm

torch.set_num_threads(1)
SCALE = 15.0
CPU = {"device": "cpu"}


def _inputs(rng, b, h, w):
    planes = natural_frames(rng, b, h, w).transpose(0, 3, 1, 2).copy()
    (nbh, nbw), cap = block_grid((h, w), 4)
    wm2d = spread_wm(h, w)[: nbh * nbw].reshape(nbh, nbw)
    return planes, wm2d, (nbh, nbw), cap


def _jax_int_mark(planes, wm2d, chan=1):
    return np.asarray(jfe.fused_mark_planar(jnp.asarray(planes), jnp.asarray(wm2d), SCALE, chan,
                                            interpret=True, int_path=True))


def _port_int_mark(planes, wm2d, chan=1):
    return tfe.fused_mark_planar_reference(torch.from_numpy(planes), torch.from_numpy(wm2d),
                                           SCALE, chan, int_path=True).numpy()


# -- the integer constants ----------------------------------------------------------

@pytest.mark.parametrize("chan", [0, 1, 2])
def test_int_constants_equal_the_pallas_bodies(chan):
    """The colour row at 2^14 as ``_int_mac`` forms it (read back through unit
    pixels) and the backward column at 2^10 as the epilogue rounds it."""
    assert (tfe._MAC_SH, tfe._EPI_SH) == (jfe._MAC_SH, jfe._EPI_SH)
    unit = jnp.eye(3, dtype=jnp.int32)  # xi[i] = e_i: the MAC returns [mi0, mi1, mi2]
    assert np.asarray(jfe._int_mac(unit, chan)).tolist() == tfe.INT_FWD[chan]
    want = [int(round(float(jcolor.M_BWD[k, chan]) * (1 << jfe._EPI_SH))) for k in range(3)]
    assert tfe.INT_BWD[chan] == want
    host = tfe._INT_COLOR_HOST[chan]  # the launchers' words: fwd, off2's float bits, bwd
    assert host[:3].tolist() == tfe.INT_FWD[chan] and host[4:].tolist() == want
    assert host[3:4].view(np.float32)[0] == 2.0 * float(jcolor.OFF_FWD[chan])


# -- the plain int bodies against the Pallas int bodies -------------------------------

@pytest.mark.parametrize("b,h,w", FUSED_MARK_CASES, ids=_case_ids(FUSED_MARK_CASES))
def test_int_mark_reference_matches_pallas(rng, b, h, w):
    planes, wm2d, (nbh, nbw), cap = _inputs(rng, b, h, w)
    want = _jax_int_mark(planes, wm2d)
    got = _port_int_mark(planes, wm2d)
    assert (got == want).mean() >= 0.995
    bits = tfe.fused_extract_planar_reference(torch.from_numpy(got), SCALE, 1,
                                              int_path=True).numpy()
    flat = np.zeros((b, cap), np.float32)
    flat[:, : nbh * nbw] = bits.reshape(b, -1)
    for p in despread(flat):
        np.testing.assert_array_equal(p, PAYLOAD)


@pytest.mark.parametrize("h,w", FUSED_SHAPES)
def test_int_extract_reference_matches_pallas(rng, h, w):
    planes, wm2d, (nbh, nbw), _ = _inputs(rng, 2, h, w)
    marked = _jax_int_mark(planes, wm2d)
    want = np.asarray(jfe.fused_extract_planar(jnp.asarray(marked), SCALE, 1, interpret=True,
                                               int_path=True))
    got = tfe.fused_extract_planar_reference(torch.from_numpy(marked.copy()), SCALE, 1,
                                             int_path=True).numpy()
    assert got.shape == (2, nbh, nbw)
    assert (got == want).mean() >= 0.999


@pytest.mark.parametrize("chan", [0, 2])
def test_int_bodies_on_the_other_channels_match_pallas(rng, chan):
    """Y (every backward entry 1024) and V (M_BWD[0, 2] == 0: B passes through)."""
    planes, wm2d, _, _ = _inputs(rng, 2, 72, 128)
    got = _port_int_mark(planes, wm2d, chan)
    assert (got == _jax_int_mark(planes, wm2d, chan)).mean() >= 0.995
    if chan == 2:
        np.testing.assert_array_equal(got[:, 0], planes[:, 0])
    want = np.asarray(jfe.fused_extract_planar(jnp.asarray(got), SCALE, chan, interpret=True,
                                               int_path=True))
    bits = tfe.fused_extract_planar_reference(torch.from_numpy(got), SCALE, chan,
                                              int_path=True).numpy()
    assert (bits == want).mean() >= 0.999


def test_int_mark_tail_rows_pass_through(rng):
    """78 rows: rows past the block grid get duq = 0, and x << 20 + 2^19
    shifts back to x, bit for bit."""
    planes, wm2d, (nbh, _), _ = _inputs(rng, 2, 78, 128)
    assert 8 * nbh < 78 // 4 * 4
    got = _port_int_mark(planes, wm2d)
    np.testing.assert_array_equal(got[:, :, 8 * nbh:], planes[:, :, 8 * nbh:])
    np.testing.assert_array_equal(_jax_int_mark(planes, wm2d)[:, :, 8 * nbh:],
                                  planes[:, :, 8 * nbh:])


def test_int_mark_against_the_float_body(rng):
    planes, wm2d, _, _ = _inputs(rng, 2, 78, 128)
    f32 = tfe.fused_mark_planar_reference(torch.from_numpy(planes), torch.from_numpy(wm2d),
                                          SCALE, 1).numpy()
    assert (_port_int_mark(planes, wm2d) == f32).mean() >= 0.98


@pytest.mark.parametrize("value", [0, 255])
def test_int_epilogue_clamps_flat_frames(value):
    """All-0 and all-255 frames: the epilogue's clamps bite; the plain int
    body equals the Pallas int body byte for byte."""
    planes = np.full((2, 3, 40, 64), value, np.uint8)
    (nbh, nbw), _ = block_grid((40, 64), 4)
    wm2d = spread_wm(40, 64)[: nbh * nbw].reshape(nbh, nbw)
    got = _port_int_mark(planes, wm2d)
    np.testing.assert_array_equal(got, _jax_int_mark(planes, wm2d))
    assert got.min() >= 0 and got.max() <= 255


# -- the codec ------------------------------------------------------------------------

def test_codec_kernel_backend_matches_the_jax_int_codec(rng, monkeypatch):
    """``backend="kernel"`` on the CPU (the plain int bodies) against the JAX
    codec's ``backend="pallas", int_path=True`` with its kernels in interpret
    mode, spied as tests/test_kernels.py spies them: both bodies see the flag."""
    seen = {}
    real_mark, real_extract = jfe.fused_mark_planar, jfe.fused_extract_planar

    def spy_mark(planes, wm2d, scale, chan, **kw):
        seen["mark_int"] = kw.get("int_path", False)
        return real_mark(planes, wm2d, scale, chan, interpret=True, **kw)

    def spy_extract(planes, scale, chan, **kw):
        seen["extract_int"] = kw.get("int_path", False)
        return real_extract(planes, scale, chan, interpret=True, **kw)

    monkeypatch.setattr(jfe, "fused_mark_planar", spy_mark)
    monkeypatch.setattr(jfe, "fused_extract_planar", spy_extract)
    h, w = 72, 128
    frames = natural_frames(rng, 2, h, w)
    wm = spread_wm(h, w)
    jcodec = JaxCodec(backend="pallas", int_path=True)
    want = np.array(jcodec.mark_frames(jnp.asarray(frames), jnp.asarray(wm)))
    want_bits = np.asarray(jcodec.extract_frames(jnp.asarray(want)))
    assert seen == {"mark_int": True, "extract_int": True}
    codec = DwtDctSvd.from_reference(jcodec)
    assert codec == DwtDctSvd(backend="kernel", int_path=True)
    got = codec.mark_frames(torch.from_numpy(frames), torch.from_numpy(wm)).numpy()
    assert (got == want).mean() >= 0.995
    bits = codec.extract_frames(torch.from_numpy(want)).numpy()
    assert (bits == want_bits).mean() >= 0.999
    np.testing.assert_array_equal(despread(codec.extract_frames(torch.from_numpy(got))),
                                  np.tile(PAYLOAD, (2, 1)))
    # the float32 codec marks other bytes: the flag reached the kernels' plain versions
    f32 = DwtDctSvd(backend="kernel").mark_frames(torch.from_numpy(frames), torch.from_numpy(wm))
    assert not np.array_equal(got, f32.numpy())


def test_other_routes_ignore_int_path(rng):
    """The tensor path and the SoA path (W % 4 != 0) compute as the float32
    codec, as the JAX codec's XLA path does."""
    for backend, w in (("torch", 128), ("kernel", 126)):
        frames = torch.from_numpy(natural_frames(rng, 2, 72, w))
        wm = torch.from_numpy(spread_wm(72, w))
        a = DwtDctSvd(backend=backend, int_path=True)
        b = DwtDctSvd(backend=backend)
        assert torch.equal(a.mark_frames(frames, wm), b.mark_frames(frames, wm))
        assert torch.equal(a.extract_frames(frames), b.extract_frames(frames))


def test_lowlink_ignores_int_path_in_both_packages(rng, monkeypatch):
    monkeypatch.setenv("VFP_LOWLINK", "1")
    monkeypatch.delenv("VFP_LL_WIRE", raising=False)
    frames = natural_frames(rng, 3, 64, 96)
    wm = spread_wm(64, 96)
    deg = DeShuffler(key=0, threshold="fixed").set_shape(PAYLOAD.shape)
    jdeg = JaxDeShuffler(key=0, threshold="fixed").set_shape(PAYLOAD.shape)
    port = {}
    for int_path in (False, True):
        fm = tpipe.FrameMarker(DwtDctSvd(int_path=int_path), wm, 4, **CPU)
        assert fm._ll is not None
        marked = fm.mark(frames)
        fx = tpipe.FrameExtractor(DwtDctSvd(int_path=int_path), deg, 4, **CPU)
        assert fx._ll is not None
        port[int_path] = (marked, fx.extract(marked))
        jmarked = jpipe.FrameMarker(JaxCodec(int_path=int_path), wm, 4).mark(frames)
        jax_false = jpipe.FrameMarker(JaxCodec(), wm, 4).mark(frames)
        np.testing.assert_array_equal(jmarked, jax_false)
        np.testing.assert_array_equal(
            jpipe.FrameExtractor(JaxCodec(int_path=int_path), jdeg, 4).extract(marked),
            port[int_path][1])
    np.testing.assert_array_equal(port[True][0], port[False][0])
    np.testing.assert_array_equal(port[True][1], np.tile(PAYLOAD, (3, 1)))


def test_int_path_keys_the_codec_and_the_cached_extractor():
    a, b = DwtDctSvd(int_path=True), DwtDctSvd()
    assert a != b and hash(a) != hash(b)
    assert a == DwtDctSvd(int_path=True) and hash(a) == hash(DwtDctSvd(int_path=True))
    ea = cached_bit_extractor(a, 0, 8, **CPU)
    assert ea is cached_bit_extractor(DwtDctSvd(int_path=True), 0, 8, **CPU)
    assert ea is not cached_bit_extractor(b, 0, 8, **CPU)
    assert ea.codec.int_path and not cached_bit_extractor(b, 0, 8, **CPU).codec.int_path


# -- the last public names ---------------------------------------------------------------

@pytest.mark.parametrize("name", ["dwtDctSvd", "dct", "dtcwtKey", "dtcwtImg", "svd"])
def test_config_make_codec_method_is_the_module_function(name):
    cfg = VfpConfig(codec=CodecConfig(scales=(0.0, 9.0, 0.0), backend="xla", alpha_dct=12.0,
                                      alpha_key=7.0, alpha_img=2.0, step=4.0))
    assert cfg.make_codec(name) == make_codec(name, cfg)
    assert VfpConfig().make_codec(name) == make_codec(name)
    jax_codec = JaxConfig.from_dict(cfg.to_dict()).make_codec(name)
    if name in ("dwtDctSvd", "svd"):
        assert cfg.make_codec(name) == DwtDctSvd.from_reference(jax_codec)
    with pytest.raises(ValueError):
        cfg.make_codec("nope")


def _raw_frames(rng, tmp_path, n=37, h=24, w=40):
    frames = rng.randint(0, 256, (n, h, w, 3)).astype(np.uint8)
    path = tmp_path / "frames.raw"
    path.write_bytes(frames.tobytes())
    return frames, path


def _read_all(reader, n):
    out = []
    while (batch := reader.read_batch(n)) is not None:
        out.append(batch)
    reader.close()
    return np.concatenate(out)


def test_native_pipe_reader_equals_the_jax_one(rng, tmp_path):
    frames, path = _raw_frames(rng, tmp_path)
    got = _read_all(NativePipeReader(f"cat '{path}'", 40, 24, fps=25.0), 10)
    want = _read_all(JaxPipeReader(f"cat '{path}'", 40, 24, fps=25.0), 10)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, frames)


def test_native_pipe_writer_equals_the_jax_one(rng, tmp_path):
    frames, _ = _raw_frames(rng, tmp_path)
    for cls, name in ((NativePipeWriter, "port.raw"), (JaxPipeWriter, "jax.raw")):
        w = cls(f"cat > '{tmp_path / name}'", 40, 24)
        w.write_batch(frames[:20])
        w.write_batch(frames[20:])
        w.close()
    assert (tmp_path / "port.raw").read_bytes() == (tmp_path / "jax.raw").read_bytes()
    assert (tmp_path / "port.raw").read_bytes() == frames.tobytes()


def test_native_pipes_raise_on_a_nonzero_exit(rng, tmp_path):
    """A command that exits nonzero raises at ``close``, for the reader after
    its stream and for the writer after its input; a reader closed while
    its command still runs stops it without raising."""
    frames, path = _raw_frames(rng, tmp_path)
    r = NativePipeReader(f"cat '{path}'; exit 3", 40, 24)
    with pytest.raises(IOError, match="code 3"):
        _read_all(r, 16)
    w = NativePipeWriter("cat > /dev/null; exit 5", 40, 24)
    w.write_batch(frames)
    with pytest.raises(IOError, match="code 5"):
        w.close()
    r = NativePipeReader("sleep 30", 40, 24)
    r.close()  # no raise, no wait for the command
    r = NativePipeReader("exit 0", 40, 24)
    assert r.read_batch(1) is None  # an empty stream reads as its end
    r.close()


@pytest.mark.parametrize("iters", [None, 2, 8])
def test_jacobi_triplet_matches_jax(rng, iters):
    m = (rng.rand(2, 16, 300) * 300).astype(np.float32)
    m[0, :, :4] = 0  # zero blocks: the guards' fallbacks
    m[1, :, 4] = np.eye(4, dtype=np.float32).reshape(-1) * 7  # a tied spectrum
    ws0, wu, wv = (np.asarray(a) for a in jsoa.top_triplet_soa(jnp.asarray(m), method="jacobi",
                                                               iters=iters))
    s0, u, v = (a.numpy() for a in tsoa.top_triplet_soa(torch.from_numpy(m), method="jacobi",
                                                        iters=iters))
    np.testing.assert_allclose(s0, ws0, rtol=2e-5, atol=1e-30)
    np.testing.assert_allclose(u[:, :, None] * v[:, None], wu[:, :, None] * wv[:, None],
                               atol=2e-5)
    if iters is None:  # converged (2 sweeps are not): both methods find the dominant s0
        power = tsoa.top_triplet_soa(torch.from_numpy(m))[0].numpy()
        np.testing.assert_allclose(s0, power, rtol=1e-4)
    with pytest.raises(ValueError):
        tsoa.top_triplet_soa(torch.from_numpy(m), method="qr")
