"""vfp_tpu_torch.pipeline.lowlink (the LL-domain transport) and its native
host half against vfp_tpu.pipeline.lowlink, on the CPU, with
``VFP_LOWLINK=1`` on both sides.  The JAX side runs its XLA/CPU path, as
``tests/test_lowlink.py`` runs it, and its native library (g++).

Sizes: 64x96, 78x102 / 78x128, 239x317 (odd: the crop path) and, for the
centring and lossy-chroma cases, 240x320, as the JAX tests.  Stated
tolerance (``tests/test_lowlink.py:75-91``, and the codecs' f32 noise of
``tests/test_torch_codec.py:127-140``):

- the native functions against the JAX library on the same inputs: equal
  bytes (the same C code, built by both packages);
- against their NumPy twins: host_ll within 1 f16 ulp (equal on > 99%),
  reconstruct equal, the QIM functions in decision parity: >= 99% of
  blocks equal, every other block centred on a centre of the same bit;
- int8 delta planes equal on >= 99.9% of entries and never more than 1
  apart; marked frames within +-1 on >= 99.9% of pixels; decoded payloads,
  traced patterns and manifests identical.  The host wire runs the same C
  code in both packages, so its marked frames are equal.
"""

import ctypes
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfp_tpu import fingerprint as jfp, pipeline as jpipe
from vfp_tpu.cli.__main__ import main as jax_cli
from vfp_tpu.fingerprint import payload_for_segment
from vfp_tpu.pipeline import lowlink as jll
from vfp_tpu.wm import DeShuffler as JaxDeShuffler, DwtDctSvd as JaxCodec, Shuffler
from vfp_tpu_torch import fingerprint as tfp, pipeline as tpipe
from vfp_tpu_torch.cli import main as port_cli
from vfp_tpu_torch.fingerprint import marker as tmarker
from vfp_tpu_torch.io import RawVideoReader, RawVideoWriter
from vfp_tpu_torch.native import lowlink as native
from vfp_tpu_torch.ops.color import M_FWD, OFF_FWD
from vfp_tpu_torch.pipeline import lowlink as tll
from vfp_tpu_torch.wm import DctQim, DeShuffler, DwtDctSvd

from test_torch_fingerprint import _result_lines
from torch_parity import PAYLOAD, natural_frames

torch.set_num_threads(1)
CPU = {"device": "cpu"}
PLANE_EQ, PIXEL_LE1 = 0.999, 0.999


@pytest.fixture(autouse=True)
def lowlink_on(monkeypatch):
    monkeypatch.setenv("VFP_LOWLINK", "1")
    monkeypatch.delenv("VFP_LL_WIRE", raising=False)


def wms_for(h, w, n, seg=1):
    cap = (1, h * w // 64)
    return [np.asarray(Shuffler(key=0).generate_wm(payload_for_segment(seg, c), cap),
                       np.float32).reshape(-1) for c in range(n)]


def payload_wm(h, w):
    return np.asarray(Shuffler(key=0).generate_wm(PAYLOAD, (1, h * w // 64)),
                      np.float32).reshape(-1)


def port_marker(wms, batch, wire=None, packer=None, codec=None):
    return tll.LowLinkMarker(codec or DwtDctSvd(), wms, batch, packer=packer, wire=wire, **CPU)


def assert_pixels_close(got, want):
    assert got.shape == want.shape
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert (d <= 1).mean() >= PIXEL_LE1, (d <= 1).mean()


def assert_planes_close(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype == np.int8
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert (d == 0).mean() >= PLANE_EQ and d.max() <= 1, ((d == 0).mean(), d.max())


def blocks_of(a, blk=4):
    """[..., hc, wc] -> [..., nbh, nbw, blk, blk]."""
    *lead, hc, wc = a.shape
    nbh, nbw = hc // blk, wc // blk
    v = a[..., : nbh * blk, : nbw * blk].reshape(*lead, nbh, blk, nbw, blk)
    return np.moveaxis(v, -3, -2)


def same_bit_centres(ll16, dll, bits, scale):
    """Every block of ``dll`` [P, k, hc, wc] moves its block of ``ll16`` to
    an s0 that decodes to that plane's bit (the decision-parity invariant)."""
    x = blocks_of(ll16.astype(np.float32))
    d = blocks_of(dll.astype(np.float32)) / native.DLL_Q
    nbh, nbw = x.shape[1:3]
    for p in range(len(dll)):
        s0 = np.linalg.svd(x + d[p], compute_uv=False)[..., 0]
        want = bits[p][: nbh * nbw].reshape(nbh, nbw) > 0.5
        assert ((np.fmod(s0, scale) > scale * 0.5) == want).all()


# -- the native functions ----------------------------------------------------------

class TestNative:
    @pytest.mark.parametrize("chan", [0, 1, 2])
    @pytest.mark.parametrize("h,w", [(79, 101), (64, 96)])
    def test_host_ll_equals_jax_library_and_twin(self, rng, chan, h, w):
        frames = rng.randint(0, 256, (3, h, w, 3), np.uint8)
        got = native.host_ll(frames, M_FWD[chan], OFF_FWD[chan])
        want = jll.host_ll(frames, chan)
        assert got.dtype == np.float16 and got.shape == (3, h // 4 * 2, w // 4 * 2)
        np.testing.assert_array_equal(got.view(np.uint16), want.view(np.uint16))
        twin = native.host_ll_reference(frames, M_FWD[chan], OFF_FWD[chan])
        a, b = got.astype(np.float32), twin.astype(np.float32)
        assert np.all(np.abs(a - b) <= np.spacing(np.abs(b)).astype(np.float32) * 1.01)
        assert (a == b).mean() > 0.99
        np.testing.assert_array_equal(tll.host_ll(frames, chan).view(np.uint16),
                                      want.view(np.uint16))

    def test_reconstruct_equals_jax_library_and_twin(self, rng):
        frames = rng.randint(0, 256, (3, 79, 101, 3), np.uint8)
        frames[0, :4] = 255  # clamps high
        frames[1, :4] = 0    # clamps low
        dll = rng.randint(-127, 128, (2, 3, 38, 50)).astype(np.int8)
        got = tll.reconstruct_all(frames, dll, 1)
        np.testing.assert_array_equal(got, jll.reconstruct_all(frames, dll, 1))
        luts = tll._delta_luts(1)
        assert luts[2] is None  # R has no U term: copied
        for v in range(2):
            np.testing.assert_array_equal(got[v], native.reconstruct_reference(frames, dll[v],
                                                                               luts))
        np.testing.assert_array_equal(got[0], tll.reconstruct(frames, dll[0], 1))

    def test_qim_dll_equals_jax_library_and_twin(self, rng):
        codec = DwtDctSvd()
        scale = float(codec.scales[1])
        ll = (rng.rand(3, 60, 82).astype(np.float32) * 400).astype(np.float16)
        bits = rng.randint(0, 2, (2, 15 * 20)).astype(np.float32)
        got = tll.host_dll(ll, codec, 1, bits)
        np.testing.assert_array_equal(got, jll.host_dll(ll, JaxCodec(), 1, bits))
        assert not got[..., 80:].any()  # past the block grid
        twin = native.qim_dll_reference(ll, bits, scale)
        same = (blocks_of(got) == blocks_of(twin)).all((-2, -1))
        assert same.mean() > 0.99, same.mean()
        same_bit_centres(ll, got, bits, scale)
        same_bit_centres(ll, twin, bits, scale)
        with pytest.raises(ValueError, match="plane_bits cover"):
            tll.host_dll(ll, codec, 1, bits[:, :10])

    def test_qim_bits_equal_jax_library_and_twin_on_marked(self, rng):
        codec = DwtDctSvd()
        frames = (rng.rand(2, 96, 128, 3) * 255).astype(np.uint8)
        cap = codec.wm_capacity(frames.shape[1:])
        wm = Shuffler(key=0).generate_wm(np.arange(8) % 2, cap)
        marked = port_marker([wm], 2, wire="host").mark_all(frames)[0]
        ll = tll.host_ll(marked, 1)
        total = int(np.prod(cap))
        got = tll.host_extract_bits(ll, codec, 1, total)
        np.testing.assert_array_equal(got, jll.host_extract_bits(ll, JaxCodec(), 1, total))
        np.testing.assert_array_equal(got[:, : 24 * 32],
                                      native.qim_bits_reference(ll, 15.0).astype(np.float32))
        assert not got[:, 24 * 32:].any()

    def test_qim_repair_equals_jax_library_and_twin(self, rng):
        P, k, hc, wc, scale = 3, 2, 42, 58, 15.0
        ll = (rng.rand(k, hc, wc) * 300).astype(np.float16)
        small = rng.rand(P, k, hc // 4, wc // 4) < 0.3
        bits = rng.randint(0, 2, (P, (hc // 4) * (wc // 4))).astype(np.float32)
        start = rng.randint(-50, 50, (P, k, hc, wc)).astype(np.int8)
        got, want, twin = start.copy(), start.copy(), start.copy()
        tll._repair_small_blocks(got, small, ll, 4, scale, bits)
        jll._repair_small_blocks(want, small, ll, 4, scale, bits)
        np.testing.assert_array_equal(got, want)
        native.qim_repair_reference(twin, small, ll, bits, scale)
        same = (blocks_of(got) == blocks_of(twin)).all((-2, -1))
        assert same[small].mean() > 0.99 and same[~small].all()
        keep = ~np.repeat(np.repeat(small, 4, 2), 4, 3)
        np.testing.assert_array_equal(got[:, :, :40, :56][keep], start[:, :, :40, :56][keep])
        with pytest.raises(ValueError, match="C-contiguous"):
            native.qim_repair(got[:, :, :, ::2], small, ll, bits, scale)

    def test_recentre_equals_jax_library_and_twin(self, rng):
        P, k, hc, wc, blk = 3, 4, 117, 163, 4
        dll = rng.randint(-100, 100, (P, k, hc, wc)).astype(np.int8)
        dll[:, :, :16, :16] = rng.randint(-2, 2, (P, k, 16, 16)).astype(np.int8)  # below the floor
        E = rng.randn(k, hc, wc).astype(np.float32) * 0.1
        ll = (rng.rand(k, hc, wc) * 255).astype(np.float16)
        ll[:, 20:36, 20:36] = 100.0  # flat: the direction gate flags it
        got, small = native.recentre(dll, E, ll.astype(np.float32), blk, tll.WIRE_DU_MIN,
                                     tll.WIRE_DIR_GAMMA2)
        lib = jll._native_reconstruct()  # the JAX package's build of the same function
        want, want_small = dll.copy(), np.zeros_like(small)
        x32 = np.ascontiguousarray(ll, np.float32)
        lib.vfpio_recentre2(dll.ctypes.data_as(ctypes.c_char_p),
                            E.ctypes.data_as(ctypes.c_void_p),
                            x32.ctypes.data_as(ctypes.c_void_p),
                            want.ctypes.data_as(ctypes.c_char_p),
                            want_small.ctypes.data_as(ctypes.c_char_p),
                            P, k, hc, wc, blk, ctypes.c_float(jll.DLL_Q),
                            ctypes.c_float(jll.WIRE_DU_MIN), ctypes.c_float(jll.WIRE_DIR_GAMMA2))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(small, want_small)
        assert small[:, :, 5:9, 5:9].all() and 0 < small.mean() < 0.1
        twin, twin_small = native.recentre_reference(dll, E, ll.astype(np.float32), blk,
                                                     tll.WIRE_DU_MIN, tll.WIRE_DIR_GAMMA2)
        np.testing.assert_array_equal(twin_small, small)
        d = np.abs(twin.astype(np.int16) - got.astype(np.int16))
        assert d.max() <= 1 and (d == 0).mean() > 0.9999
        # the whole recentre (repairs included) equals the JAX function's
        scale = 45.0
        bits = rng.randint(0, 2, (P, (hc // blk) * (wc // blk))).astype(np.float32)
        st, jst = {}, {}
        np.testing.assert_array_equal(
            tll.recentre_dll(dll, E, ll, blk, scale, bits, stats=st),
            jll.recentre_dll(dll, E, ll, blk, scale, bits, stats=jst))
        assert st == jst and 0 < st["repair_frac"] < 1

    def test_other_block_sizes_take_the_twins(self, rng):
        """The C functions fix the block at 4x4; blk 2 runs the NumPy twins,
        as the JAX package's fallback does."""
        codec = DwtDctSvd(blk=2)
        ll = (rng.rand(2, 32, 48) * 300).astype(np.float16)
        bits = rng.randint(0, 2, (2, 16 * 24)).astype(np.float32)
        np.testing.assert_array_equal(tll.host_dll(ll, codec, 1, bits),
                                      native.qim_dll_reference(ll, bits, 15.0, 2))
        np.testing.assert_array_equal(
            tll.host_extract_bits(ll, codec, 1, 400)[:, :384],
            native.qim_bits_reference(ll, 15.0, 2).astype(np.float32))


# -- the transport ----------------------------------------------------------------

class TestHostLL:
    def test_matches_device_ll(self, rng):
        codec = DwtDctSvd()
        frames = natural_frames(rng, 2, 78, 102)
        want = codec._ll_from_frames(torch.as_tensor(frames).to(torch.float32), 1).numpy()
        got = tll.host_ll(frames, 1).astype(np.float32)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=0.13)  # f16 quantization


class TestLowLinkMarker:
    @pytest.mark.parametrize("wire", ["f16", "u8", "host"])
    @pytest.mark.parametrize("n_variants", [1, 2, 3])
    @pytest.mark.parametrize("h,w,k,batch", [(64, 96, 4, 4), (239, 317, 3, 8), (78, 128, 5, 4)])
    def test_matches_jax(self, rng, wire, n_variants, h, w, k, batch):
        frames = natural_frames(rng, k, h, w)
        wms = wms_for(h, w, n_variants)
        mm = port_marker(wms, batch, wire=wire)
        assert mm._two_plane == (n_variants >= 3) and mm.n_variants == n_variants
        got = mm.mark_all(frames)
        want = jll.LowLinkMarker(JaxCodec(), wms, batch, wire=wire).mark_all(frames)
        assert got.shape == (n_variants, k, h, w, 3) and got.dtype == np.uint8
        if wire == "host":  # the same C code on both sides
            np.testing.assert_array_equal(got, want)
        assert_pixels_close(got, want)
        # untouched outside the 4-aligned crop and in the R channel
        np.testing.assert_array_equal(got[:, :, h // 4 * 4:], np.broadcast_to(
            frames[:, h // 4 * 4:], got[:, :, h // 4 * 4:].shape))
        np.testing.assert_array_equal(got[..., 2], np.broadcast_to(frames[..., 2],
                                                                   got[..., 2].shape))
        deg = DeShuffler(key=0, threshold="fixed").set_shape((8,))
        codec = DwtDctSvd()
        for v in range(n_variants):
            bits = codec.extract_frames(torch.as_tensor(got[v]))
            for b in deg.degenerate_batch(bits).numpy():
                np.testing.assert_array_equal(b, payload_for_segment(1, v))

    @pytest.mark.parametrize("wire", ["f16", "u8"])
    @pytest.mark.parametrize("n_variants", [1, 2, 3])
    def test_int8_planes_match_jax(self, rng, wire, n_variants):
        """The device function's output, the int8 delta planes, against the
        JAX jitted function's on the same wire LL."""
        frames = natural_frames(rng, 4, 78, 128)
        wms = wms_for(78, 128, n_variants)
        llw = tll.wire_encode(tll.host_ll(frames, 1), wire, 1)
        x = torch.as_tensor(llw)
        if n_variants >= 3:
            got = tll._mark_2plane(DwtDctSvd(), 1, x).numpy()
            want = np.asarray(jll._mark_fn_2plane(JaxCodec())(llw))
        else:
            got = tll._mark(DwtDctSvd(), 1, x, torch.as_tensor(np.stack(wms))).numpy()
            want = np.asarray(jll._mark_fn(JaxCodec(), n_variants)(llw, np.stack(wms)))
        assert_planes_close(got, want)
        np.testing.assert_array_equal(tll._wire_decode(x, 1).numpy(),
                                      np.asarray(jll._wire_decode(jnp.asarray(llw), 1)))

    def test_quantize_rounds_half_to_even_and_clips(self):
        d = torch.tensor([0.0625, 0.1875, -0.0625, 20.0, -20.0, 0.3125])
        np.testing.assert_array_equal(tll._quantize(d).numpy(), [0, 2, 0, 127, -127, 2])

    def test_two_plane_matches_per_variant(self, rng):
        frames = natural_frames(rng, 3, 78, 102)
        wms = wms_for(78, 102, 3, seg=2)
        mm = port_marker(wms, 4)
        assert mm._two_plane
        got = mm.mark_all(frames)
        for v in range(3):
            ref = port_marker([wms[v]], 4)
            assert not ref._two_plane
            np.testing.assert_array_equal(got[v], ref.mark_all(frames)[0])

    def test_submit_collect_pipelined(self, rng):
        frames = natural_frames(rng, 8, 64, 96)
        mm = port_marker(wms_for(64, 96, 1), 4)
        handles = [mm.submit(frames[:4]), mm.submit(frames[4:])]
        outs = [mm.collect(h) for h in handles]
        np.testing.assert_array_equal(outs[0], mm.mark_all(frames[:4]))
        np.testing.assert_array_equal(outs[1], mm.mark_all(frames[4:]))
        assert set(mm.stage_seconds) == {"host_ll", "dispatch", "link_fetch", "recentre",
                                         "host_qim", "reconstruct"}

    def test_frame_and_multi_marker_route_by_policy(self, rng, monkeypatch):
        frames = natural_frames(rng, 3, 64, 96)
        wms = wms_for(64, 96, 3)
        fm = tpipe.FrameMarker(DwtDctSvd(), wms[0], batch_size=4, **CPU)
        assert fm._ll is not None and fm.wm is None
        np.testing.assert_array_equal(fm.mark(frames), port_marker([wms[0]], 4).mark_all(frames)[0])
        assert_pixels_close(fm.mark(frames),
                            jpipe.FrameMarker(JaxCodec(), wms[0], batch_size=4).mark(frames))
        mm = tpipe.MultiMarker(DwtDctSvd(), wms, batch_size=4, **CPU)
        assert mm._ll is not None and mm.n_variants == 3
        got = mm.collect(mm.submit(frames))
        np.testing.assert_array_equal(got, mm.mark_all(frames))
        assert_pixels_close(got, jpipe.MultiMarker(JaxCodec(), wms, batch_size=4).mark_all(frames))
        monkeypatch.delenv("VFP_LOWLINK")  # the port's default: the full-frame path
        assert tpipe.FrameMarker(DwtDctSvd(), wms[0], 4, **CPU)._ll is None
        assert tpipe.MultiMarker(DwtDctSvd(), wms, 4, **CPU)._ll is None


class TestPackedTwoPlane:
    def test_packed_matches_unpacked_across_segments(self, rng):
        """4 segments of 6 frames share 16-frame device calls; the collect of
        the tail forces a partial call of 8 (one call: no power-of-two split)."""
        segs = [natural_frames(rng, 6, 64, 96) for _ in range(4)]
        wms = [wms_for(64, 96, 3, seg=i) for i in range(4)]
        packer = tll.PackedTwoPlane(DwtDctSvd(), pack=16, **CPU)
        mms = [port_marker(w, 16, packer=packer) for w in wms]
        assert all(m._packer is packer for m in mms)
        handles = [m.submit(f) for m, f in zip(mms, segs)]
        gots = [m.collect(h) for m, h in zip(mms, handles)]
        assert packer.calls == 2 and packer.call_frames == [16, 8]
        jpacker = jll.PackedTwoPlane(JaxCodec(), pack=16)
        for got, w, f in zip(gots, wms, segs):
            np.testing.assert_array_equal(got, port_marker(w, 16).mark_all(f))
            assert_pixels_close(got, jll.LowLinkMarker(JaxCodec(), w, 16,
                                                       packer=jpacker).mark_all(f))

    def test_dim_change_flushes_chunk(self, rng):
        packer = tll.PackedTwoPlane(DwtDctSvd(), pack=16, **CPU)
        a, b = natural_frames(rng, 5, 64, 96), natural_frames(rng, 5, 80, 112)
        ma = port_marker(wms_for(64, 96, 3), 16, packer=packer)
        mb = port_marker(wms_for(80, 112, 3), 16, packer=packer)
        ha = ma.submit(a)
        hb = mb.submit(b)  # a size change dispatches the pending 64x96 pieces
        assert packer.call_frames == [5]
        got_b, got_a = mb.collect(hb), ma.collect(ha)
        np.testing.assert_array_equal(got_a, port_marker(wms_for(64, 96, 3), 16).mark_all(a))
        np.testing.assert_array_equal(got_b, port_marker(wms_for(80, 112, 3), 16).mark_all(b))

    def test_explicit_flush_and_single_piece(self, rng):
        frames = natural_frames(rng, 3, 64, 96)
        wms = wms_for(64, 96, 3, seg=0)
        packer = tll.PackedTwoPlane(DwtDctSvd(), pack=16, **CPU)
        mm = port_marker(wms, 16, packer=packer)
        h = mm.submit(frames)
        packer.flush()  # stream end: the 3-frame tail in one call (the JAX class: 2 + 1)
        assert packer.calls == 1 and packer.call_frames == [3]
        np.testing.assert_array_equal(mm.collect(h), port_marker(wms, 16).mark_all(frames))

    def test_host_wire_and_few_variants_bypass_the_packer(self):
        packer = tll.PackedTwoPlane(DwtDctSvd(), pack=16, **CPU)
        assert port_marker(wms_for(64, 96, 3), 16, wire="host", packer=packer)._packer is None
        assert port_marker(wms_for(64, 96, 2), 16, packer=packer)._packer is None
        assert port_marker(wms_for(64, 96, 3), 16, packer=packer,
                           codec=DwtDctSvd(blk=4, backend="torch"))._packer is None


class TestLowLinkExtractor:
    @pytest.mark.parametrize("wire", ["f16", "u8", "host"])
    def test_matches_jax_and_full_frame(self, rng, wire, monkeypatch):
        frames = natural_frames(rng, 5, 64, 96)
        marked = np.asarray(JaxCodec().mark_frames(jnp.asarray(frames),
                                                   jnp.asarray(payload_wm(64, 96))))
        deg = DeShuffler(key=0, threshold="fixed").set_shape(PAYLOAD.shape)
        fx = tll.LowLinkExtractor(DwtDctSvd(), deg, batch_size=4, wire=wire, **CPU)
        got = fx.extract(marked)
        jdeg = JaxDeShuffler(key=0, threshold="fixed").set_shape(PAYLOAD.shape)
        np.testing.assert_array_equal(
            got, jll.LowLinkExtractor(JaxCodec(), jdeg, batch_size=4, wire=wire).extract(marked))
        np.testing.assert_array_equal(got, np.tile(PAYLOAD, (5, 1)))
        monkeypatch.setenv("VFP_LOWLINK", "0")
        full = tpipe.FrameExtractor(DwtDctSvd(), deg, batch_size=4, **CPU)
        assert full._ll is None
        np.testing.assert_array_equal(got, full.extract(marked))

    def test_frame_extractor_routes_and_pipelines(self, rng):
        frames = natural_frames(rng, 6, 78, 102)
        marked = port_marker(wms_for(78, 102, 1), 4).mark_all(frames)[0]
        fx = tpipe.FrameExtractor(DwtDctSvd(), DeShuffler(0, "fixed").set_shape((8,)), 4, **CPU)
        assert fx._ll is not None
        handles = [fx.submit(marked[:4]), fx.submit(marked[4:])]
        got = np.concatenate([fx.collect(h) for h in handles])
        assert got.dtype == np.uint8 and got.shape == (6, 8)
        np.testing.assert_array_equal(got, np.tile(payload_for_segment(1, 0), (6, 1)))

    def test_degenerate_batch_np_matches_torch_and_jax(self, rng):
        bits = (rng.rand(3, 2, 100) > 0.4).astype(np.float32)
        for thr in ("fixed", "midpoint"):
            deg = DeShuffler(key=5, threshold=thr).set_shape((8,))
            want = deg.degenerate_batch(torch.as_tensor(bits)).numpy()
            np.testing.assert_array_equal(deg.degenerate_batch_np(bits), want)
            np.testing.assert_array_equal(
                JaxDeShuffler(key=5, threshold=thr).set_shape((8,)).degenerate_batch_np(bits),
                want)


class TestU8Wire:
    def test_mark_and_extract_clean(self, rng):
        codec = DwtDctSvd()
        frames = natural_frames(rng, 4, 64, 96)
        wm = payload_wm(64, 96)
        got = port_marker([wm], 4, wire="u8").mark_all(frames)[0]
        exact = codec.mark_frames(torch.as_tensor(frames), torch.as_tensor(wm))
        bits = codec.extract_frames(torch.as_tensor(got)).numpy()
        bits_exact = codec.extract_frames(exact).numpy()
        nb = (64 // 8) * (96 // 8)
        np.testing.assert_array_equal(bits[:, :nb], bits_exact[:, :nb])
        assert (bits_exact[:, :nb] != wm[:nb]).mean() < 0.01
        deg = DeShuffler(key=0, threshold="fixed").set_shape((8,))
        fx = tll.LowLinkExtractor(codec, deg, batch_size=4, wire="u8", **CPU)
        for p in fx.extract(exact.numpy()):
            np.testing.assert_array_equal(p, PAYLOAD)

    def test_u8_centring_matches_f16(self, rng):
        """Each marked block's s0 sits as close to its QIM centre on the u8
        wire as on the f16 wire (the attack margin is that distance)."""
        frames = natural_frames(rng, 4, 240, 320)
        wm = wms_for(240, 320, 1)[0]
        scale = 15.0

        def off_centre(marked):
            s0, _, _ = native.triplet_reference(
                blocks_of(tll.host_ll(marked, 1).astype(np.float32)).reshape(-1, 4, 4))
            return np.abs((s0 % (scale / 2)) - scale / 4)

        off_u8 = off_centre(port_marker([wm], 4, wire="u8").mark_all(frames)[0])
        off_f16 = off_centre(port_marker([wm], 4, wire="f16").mark_all(frames)[0])
        rms = lambda x: float(np.sqrt((x ** 2).mean()))  # noqa: E731
        assert rms(off_u8) <= rms(off_f16) + 0.05, (rms(off_u8), rms(off_f16))
        assert np.percentile(off_u8, 99) <= np.percentile(off_f16, 99) + 0.15
        assert off_u8.max() <= scale / 4 + 1e-3

    def test_flat_chroma_survives_lossy_encode(self, rng):
        """Grayscale content (U LL constant 1.0) quantizes to all-zero wire
        bytes; the direction gate repairs every block from the true LL, so
        the u8 wire's frames equal the host wire's, in both packages, and
        the mark survives JPEG-95."""
        import cv2

        codec = DwtDctSvd()
        g = (rng.rand(4, 240, 320, 1) * 30 + 100).astype(np.uint8)
        frames = np.repeat(g, 3, axis=3)
        cap = codec.wm_capacity(frames.shape[1:])
        wms = [rng.randint(0, 2, cap[1]).astype(np.float32) for _ in range(3)]
        got = port_marker(wms, 4, wire="u8").mark_all(frames)
        np.testing.assert_array_equal(got, port_marker(wms, 4, wire="host").mark_all(frames))
        np.testing.assert_array_equal(
            got, jll.LowLinkMarker(JaxCodec(), wms, 4, wire="u8").mark_all(frames))
        nb = (240 // 8) * (320 // 8)
        for v in range(3):
            errs = []
            for f in got[v]:
                _, enc = cv2.imencode(".jpg", f, [cv2.IMWRITE_JPEG_QUALITY, 95])
                bits = codec.extract_frames(torch.as_tensor(cv2.imdecode(enc, 1)[None]))
                errs.append(float(np.mean(bits.numpy()[0, :nb] != wms[v][:nb])))
            assert max(errs) < 0.005, errs

    def test_host_wire_makes_no_device_call(self, rng, monkeypatch):
        """The host wire on a CUDA marker and extractor: no tensor is made
        and CUDA is never asked (the device is named, not touched)."""
        def no_device(*a, **k):
            raise AssertionError("the host wire reached torch")

        codec = DwtDctSvd()
        frames = natural_frames(rng, 4, 96, 128)
        wm = wms_for(96, 128, 1)[0]
        monkeypatch.setenv("VFP_LL_WIRE", "host")
        for name in ("as_tensor", "from_numpy", "tensor", "empty"):
            monkeypatch.setattr(torch, name, no_device)
        monkeypatch.setattr(torch.cuda, "is_available", no_device)
        fm = tpipe.FrameMarker(codec, wm, batch_size=4, device="cuda")
        h = fm._ll.submit(frames)
        assert isinstance(h[0], np.ndarray) and h[3] == "host"
        got = fm._ll.collect(h)[0]
        fx = tpipe.FrameExtractor(codec, DeShuffler(0, "fixed").set_shape((8,)), 4,
                                  device="cuda")
        payloads = fx.extract(got)
        monkeypatch.undo()
        np.testing.assert_array_equal(payloads, np.tile(payload_for_segment(1, 0), (4, 1)))
        exact = codec.mark_frames(torch.as_tensor(frames), torch.as_tensor(wm))
        nb = (96 // 8) * (128 // 8)
        np.testing.assert_array_equal(codec.extract_frames(torch.as_tensor(got))[:, :nb],
                                      codec.extract_frames(exact)[:, :nb])

    def test_host_wire_multi_variant(self, rng):
        frames = natural_frames(rng, 4, 64, 96)
        got = port_marker(wms_for(64, 96, 3), 4, wire="host").mark_all(frames)
        deg = DeShuffler(key=0, threshold="fixed").set_shape((8,))
        fx = tll.LowLinkExtractor(DwtDctSvd(), deg, batch_size=4, wire="host", **CPU)
        for v in range(3):
            vote = (np.mean(list(fx.extract(got[v])), 0) >= 0.5).astype(np.uint8)
            np.testing.assert_array_equal(vote, payload_for_segment(1, v))

    def test_two_plane_packed_u8(self, rng):
        frames = natural_frames(rng, 6, 64, 96)
        wms = wms_for(64, 96, 3)
        packer = tll.PackedTwoPlane(DwtDctSvd(), pack=4, wire="u8", **CPU)
        mm = port_marker(wms, 4, wire="u8", packer=packer)
        h1, h2 = mm.submit(frames[:4]), mm.submit(frames[4:])
        packer.flush()
        assert packer.call_frames == [4, 2]
        got = np.concatenate([mm.collect(h1), mm.collect(h2)], axis=1)
        jp = jll.PackedTwoPlane(JaxCodec(), pack=4, wire="u8")
        jm = jll.LowLinkMarker(JaxCodec(), wms, 4, packer=jp, wire="u8")
        j1, j2 = jm.submit(frames[:4]), jm.submit(frames[4:])
        jp.flush()
        assert_pixels_close(got, np.concatenate([jm.collect(j1), jm.collect(j2)], axis=1))
        deg = DeShuffler(key=0, threshold="fixed").set_shape((8,))
        codec = DwtDctSvd()
        for v in range(3):
            for b in deg.degenerate_batch(codec.extract_frames(torch.as_tensor(got[v]))).numpy():
                np.testing.assert_array_equal(b, payload_for_segment(1, v))

    @pytest.mark.parametrize("color", ["gray", "color"])
    def test_decision_identity_across_content(self, rng, color):
        """The direction gate's sweep (flat, noise on both sides of the gate,
        gradients, checkerboards; gray and coloured): the u8 wire's decoded
        bits equal the exact full-frame path's."""
        codec = DwtDctSvd()
        h, w = 64, 96
        nb = (h // 8) * (w // 8)
        wm = wms_for(h, w, 1)[0]
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        cases = {"flat": np.full((4, h, w), 128.0, np.float32)}
        for a in (0.25, 1.0, 4.0, 16.0, 48.0):
            cases[f"noise{a}"] = 128.0 + a * rng.randn(4, h, w).astype(np.float32)
        for a in (64.0, 8.0):
            cases[f"gradient{a}"] = 60.0 + a * (xx + yy)[None] / (h + w) * np.ones((4, 1, 1))
        for a in (2.0, 24.0):
            cases[f"checker{a}"] = 128.0 + a * (((yy // 8 + xx // 8) % 2) * 2 - 1)[None] \
                * np.ones((4, 1, 1), np.float32)
        failures = []
        for kind, base in cases.items():
            if color == "gray":
                frames = np.repeat(np.clip(base, 0, 255).astype(np.uint8)[..., None], 3, axis=3)
            else:
                chroma = rng.randn(4, 1, 1, 3).astype(np.float32) * 12
                frames = np.clip(base[..., None] + chroma, 0, 255).astype(np.uint8)
            got = port_marker([wm], 4, wire="u8").mark_all(frames)[0]
            exact = codec.mark_frames(torch.as_tensor(frames), torch.as_tensor(wm))
            bits = codec.extract_frames(torch.as_tensor(got)).numpy()
            bits_exact = codec.extract_frames(exact).numpy()
            mism = int((bits[:, :nb] != bits_exact[:, :nb]).sum())
            if mism:
                failures.append((kind, mism))
        assert not failures, failures


class TestFlatAdapt:
    def test_flat_video_takes_the_jax_route_sequence(self, rng):
        g = (rng.rand(2, 64, 96, 1) * 30 + 100).astype(np.uint8)
        frames = np.repeat(g, 3, axis=3)  # grayscale: flat U LL everywhere
        wms = [rng.randint(0, 2, 96).astype(np.float32) for _ in range(3)]
        m = port_marker(wms, 2, wire="u8")
        jm = jll.LowLinkMarker(JaxCodec(), wms, 2, wire="u8")
        want = port_marker(wms, 2, wire="host").mark_all(frames)
        tags, jtags = [], []
        A = tll._FlatAdapt
        for _ in range(A.ON_AFTER + A.PROBE_EVERY + 1):
            h, jh = m.submit(frames), jm.submit(frames)
            tags.append("host" if h[3] == "host" else "device")
            jtags.append("host" if isinstance(jh[3], str) else "device")
            np.testing.assert_array_equal(m.collect(h), want)
            np.testing.assert_array_equal(jm.collect(jh), want)
        assert tags == jtags
        on = A.ON_AFTER
        assert tags[:on] == ["device"] * on
        assert tags[on:on + A.PROBE_EVERY - 1] == ["host"] * (A.PROBE_EVERY - 1)
        assert tags[on + A.PROBE_EVERY - 1:] == ["device", "host"]
        assert m.host_batches == tags.count("host") == A.PROBE_EVERY
        assert m.stage_seconds["host_qim"] > 0

    def test_natural_video_stays_on_device(self, rng):
        frames = natural_frames(rng, 2, 64, 96)
        m = port_marker([rng.randint(0, 2, 96).astype(np.float32) for _ in range(3)], 2,
                        wire="u8")
        for _ in range(6):
            h = m.submit(frames)
            assert isinstance(h[3], tuple)
            m.collect(h)
        assert m._adapt.streak == 0 and m.host_batches == 0

    def test_packer_shares_adapt_across_markers(self, rng):
        packer = tll.PackedTwoPlane(DwtDctSvd(), pack=4, wire="u8", **CPU)
        wms = wms_for(64, 96, 3)
        m1, m2 = (port_marker(wms, 2, wire="u8", packer=packer) for _ in range(2))
        assert m1._adapt is packer.adapt and m2._adapt is packer.adapt


class TestWireAwareCaches:
    def test_cached_bit_extractor_keyed_by_wire(self, monkeypatch):
        codec = DwtDctSvd()
        monkeypatch.setenv("VFP_LL_WIRE", "u8")
        a = tpipe.cached_bit_extractor(codec, 0, 8, **CPU)
        assert a._ll is not None and a._ll.wire == "u8"
        monkeypatch.setenv("VFP_LL_WIRE", "host")
        b = tpipe.cached_bit_extractor(codec, 0, 8, **CPU)
        assert b is not a and b._ll.wire == "host"
        monkeypatch.setenv("VFP_LL_WIRE", "u8")
        assert tpipe.cached_bit_extractor(codec, 0, 8, **CPU) is a
        monkeypatch.setenv("VFP_LOWLINK", "0")
        c = tpipe.cached_bit_extractor(codec, 0, 8, **CPU)
        assert c is not a and c._ll is None

    def test_default_wire_rejects_typo(self, monkeypatch):
        monkeypatch.setenv("VFP_LL_WIRE", "hostonly")
        with pytest.raises(ValueError, match="VFP_LL_WIRE"):
            tll.default_wire()
        with pytest.raises(ValueError, match="VFP_LL_WIRE"):
            tpipe.FrameMarker(DwtDctSvd(), wms_for(64, 96, 1)[0], 4, **CPU)

    def test_auto_wire_is_u8_without_a_probe(self, monkeypatch):
        """Departure from tests/test_lowlink.py's probe tests: the port has
        no backend probe and no outage fallback.  An unset wire is u8 (the
        JAX package's answer when its backend answers), VFP_BACKEND_PROBE_S
        is not read, and only VFP_LL_WIRE=host asks for the host route."""
        monkeypatch.setenv("VFP_BACKEND_PROBE_S", "0")
        assert tll.default_wire() == "u8" == jll.default_wire()
        assert not hasattr(tll, "backend_reachable")

    def test_use_lowlink_follows_the_jax_rule(self, monkeypatch):
        from vfp_tpu.pipeline.embedder import use_lowlink as jax_use

        flagship, jflagship = DwtDctSvd(), JaxCodec()
        two = DwtDctSvd(scales=(5.0, 15.0, 0.0))
        cases = [({"VFP_LOWLINK": "1"}, True), ({"VFP_LOWLINK": "0"}, False),
                 ({"VFP_LL_WIRE": "host"}, True),
                 ({"VFP_LOWLINK": "0", "VFP_LL_WIRE": "host"}, False),
                 ({"VFP_LOWLINK": "1", "VFP_LL_WIRE": "f16"}, True)]
        for env, want in cases:
            for k in ("VFP_LOWLINK", "VFP_LL_WIRE"):
                monkeypatch.delenv(k, raising=False)
            for k, v in env.items():
                monkeypatch.setenv(k, v)
            assert tpipe.use_lowlink(flagship) is want == jax_use(jflagship), env
        monkeypatch.setenv("VFP_LOWLINK", "1")
        assert not tpipe.use_lowlink(two) and not tpipe.use_lowlink(DctQim())
        monkeypatch.delenv("VFP_LOWLINK")
        assert not tpipe.use_lowlink(flagship)  # unset: off, the port never runs on a TPU


# -- workflows ------------------------------------------------------------------------

H, W, FPS, N = 64, 96, 6, 18


@pytest.fixture(scope="module")
def source(tmp_path_factory):
    p = tmp_path_factory.mktemp("llsrc") / "source.rawv"
    with RawVideoWriter(p, W, H, fps=FPS) as w:
        w.write_batch(natural_frames(np.random.RandomState(42), N, H, W))
    return p


def _read(path):
    r = RawVideoReader(path)
    try:
        return r.read_batch(10_000)
    finally:
        r.close()


class TestWorkflows:
    @pytest.mark.parametrize("wire", ["u8", "f16", "host"])
    def test_cli_mark_detect_matches_jax(self, source, tmp_path, capsys, monkeypatch, wire):
        monkeypatch.setenv("VFP_LL_WIRE", wire)
        port_cli(["mark", str(source), str(tmp_path / "port.rawv"), "--batch-size", "4",
                  "--device", "cpu"])
        jax_cli(["mark", str(source), str(tmp_path / "jax.rawv"), "--batch-size", "4"])
        got, want = _read(tmp_path / "port.rawv"), _read(tmp_path / "jax.rawv")
        assert_pixels_close(got, want)
        if wire == "host":
            np.testing.assert_array_equal(got, want)
        capsys.readouterr()
        port_cli(["detect", str(tmp_path / "port.rawv"), "--payload", "01100101",
                  "--batch-size", "4", "--device", "cpu"])
        text = capsys.readouterr().out
        assert f"frames: {N} " in text and "majority payload: 01100101 (frequency 1.00)" in text

    def test_hls_mark_leak_trace_matches_jax(self, source, tmp_path, capsys):
        lines = {}
        for name, cli, flags in (("port", port_cli, ["--device", "cpu"]), ("jax", jax_cli, [])):
            out = tmp_path / name
            cli(["hls-mark", str(source), str(out), "--copies", "3", "--batch-size", "8",
                 *flags])
            cli(["leak", str(out / "segment_copies.json"), "--pattern", "21", *flags])
            leaked = next(out.glob("leaked_video.*"))
            cli(["trace", str(leaked), str(out / "det"), "--payload-file",
                 str(out / "segment_payloads.json"), *flags])
            lines[name] = _result_lines(capsys.readouterr().out)
        assert lines["port"] == lines["jax"]
        assert "Copy fingerprint: 21" in lines["port"] and "Success rate: 100.00%" in lines["port"]
        for f in ("segment_payloads.json", "segment_copies.json"):
            port, jax = (json.loads((tmp_path / n / f).read_text()) for n in ("port", "jax"))
            if f == "segment_copies.json":  # the JAX marker writes .avi variants
                for seg in jax["segments"].values():
                    for e in seg:
                        e["file"] = e["file"].replace(".avi", ".rawv")
            assert port == jax, f

    def test_mark_segments_stats_and_packer(self, source, tmp_path):
        segs = tfp.segment_video(source, tmp_path / "segs", 1.0)  # 3 segments of 6
        stats: dict = {}
        marked, _, _ = tfp.mark_segments(segs, tmp_path / "m", copies=3, batch_size=4,
                                         stats=stats, **CPU)
        ss = stats["stage_seconds"]
        assert {"host_ll", "dispatch", "link_fetch", "recentre", "host_qim",
                "reconstruct"} <= set(ss)
        assert ss["device_full"] == 0.0  # the transport times its own stages
        # one shared packer: 18 frames in calls of at most 16 (how many depends
        # on when the writer thread's collects overtake the submits)
        assert stats["packed_device_calls"] >= 2 and stats["packed_device_frames"] == 18
        assert stats["host_routed_batches"] == 0
        assert all(ok for _, _, ok in tmarker.verify_segments(marked, **CPU))
        jstats: dict = {}
        jmarked, _, _ = jfp.mark_segments(segs, tmp_path / "j", copies=3, batch_size=4,
                                          out_ext=".rawv", stats=jstats)
        assert set(jstats["stage_seconds"]) == set(ss)
        for a, b in zip(marked, jmarked):
            assert_pixels_close(_read(a.file), _read(b.file))

    def test_farm_workers_and_service_take_the_route(self, source, tmp_path, monkeypatch):
        """No code of their own: the farm's spawned workers inherit
        VFP_LOWLINK and mark through the transport (files byte-equal to the
        serial run's), and the service's marks and detect go through it."""
        from vfp_tpu_torch.parallel import mark_segments_parallel
        from vfp_tpu_torch.serve import VfpService

        monkeypatch.setenv("OMP_NUM_THREADS", "1")
        segs = [str(s) for s in tfp.segment_video(source, tmp_path / "segs", 1.0)]
        serial, payloads, copies = tfp.mark_segments(segs, tmp_path / "serial", copies=3,
                                                     batch_size=4, **CPU)
        farm, fp, fc = mark_segments_parallel(segs, tmp_path / "farm", copies=3, workers=2,
                                              batch_size=4, worker_device="cpu")
        assert (fp, fc) == (payloads, copies)
        for a, b in zip(serial, farm):
            assert open(a.file, "rb").read() == open(b.file, "rb").read(), a.file

        calls = {"mark": 0, "extract": 0}
        for cls, name in ((tll.LowLinkMarker, "mark"), (tll.LowLinkExtractor, "extract")):
            real = cls.submit

            def counted(self, frames, real=real, name=name):
                calls[name] += 1
                return real(self, frames)

            monkeypatch.setattr(cls, "submit", counted)
        svc = VfpService(tmp_path / "svc", num_copies=3, segment_duration=1.0, device="cpu")
        svc.process_upload(source)
        svc.start_view("alice")
        assert "error" not in svc.detect(serial[1].file)
        assert calls["mark"] == 3 and calls["extract"] == 1  # 3 segments of one batch
