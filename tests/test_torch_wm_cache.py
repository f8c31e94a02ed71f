"""The DT-CWT key codec's watermark-spectrum cache (``DtcwtKey.wm_hp_device``,
the port of the JAX codec's ``wm_hp_device``), on the CPU.

The spectrum is computed once per distinct plane: an identity cache keyed by
the tensor that owns the plane's memory, where the plane lies in it, its
version counter and its device, then a content cache keyed by the plane's
bytes, at most 8 entries each.  These tests count the spectrum computations
(``wm_highpass`` calls), hold every cached spectrum equal to a fresh one,
hold marks made with a hit, a miss and after ``clear_wm_cache()`` to
identical bytes, and hold those marks against the JAX codec with
``fast_dots=False`` as ``tests/test_torch_dtcwt.py`` does.  A fresh view of
the same plane, as each batch call passes, hits the identity cache without
reaching the host read-back (``sync.wm_spectrum``), and ``M_BWD[:, 1]`` is
placed on a device once (``sync.constant_upload``): the sites are counted
through ``profiling.sync_span``, which on a card is a wait on the device.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vfp_tpu.wm import dtcwt_codecs as jcodecs, payload_img as jpimg
from vfp_tpu_torch.ops.color import M_BWD
from vfp_tpu_torch.pipeline import FrameMarker, MultiMarker
from vfp_tpu_torch.utils import profiling
from vfp_tpu_torch.wm import CorrShuffler, DtcwtKey, clear_wm_cache, dtcwt_codecs as tcodecs

from torch_parity import natural_frames

torch.set_num_threads(1)

H, W = 128, 256
_WM_HIGHPASS = tcodecs._DtcwtBase.wm_highpass  # uncounted


@pytest.fixture
def spectra(monkeypatch):
    """Clears the caches and counts the spectrum computations."""
    clear_wm_cache()
    calls = []

    def counted(self, wm):
        calls.append(tuple(wm.shape))
        return _WM_HIGHPASS(self, wm)

    monkeypatch.setattr(tcodecs._DtcwtBase, "wm_highpass", counted)
    yield calls
    clear_wm_cache()


@pytest.fixture
def sync_sites(monkeypatch):
    """The names of the ``sync_span`` sites reached, on any device."""
    names = []

    def counted(name, tensor):
        names.append(name)
        return profiling.OFF

    monkeypatch.setattr(profiling, "sync_span", counted)
    return names


def _wm(key=0, shape=(H, W)):
    cap = DtcwtKey().wm_capacity((*shape, 3))
    return torch.as_tensor(CorrShuffler(key).generate_wm(None, cap))


def _fresh(codec, wm, shape=(H, W)):
    return _WM_HIGHPASS(codec, wm.reshape(codec.wm_capacity((*shape, 3))))


@pytest.mark.parametrize("backend", ["kernel", "torch"])
def test_the_same_object_hits(spectra, backend):
    codec, wm = DtcwtKey(backend=backend), _wm()
    first = codec.wm_hp_device((H, W), wm)
    assert codec.wm_hp_device((H, W), wm) is first
    assert len(spectra) == 1
    assert torch.equal(first, _fresh(codec, wm))


def test_an_equal_plane_in_another_tensor_hits_through_the_content_cache(spectra):
    codec, wm = DtcwtKey(backend="kernel"), _wm()
    first = codec.wm_hp_device((H, W), wm)
    for other in (wm.clone(), wm.reshape(-1), wm.reshape(-1).clone()):
        assert codec.wm_hp_device((H, W), other) is first
    assert len(spectra) == 1
    assert len(tcodecs._WM_HP_CACHE) == 1 and len(tcodecs._WM_ID_CACHE) == 4


def test_an_in_place_edit_misses(spectra):
    codec, wm = DtcwtKey(backend="kernel"), _wm()
    first = codec.wm_hp_device((H, W), wm)
    wm[0, 0] += 1.0  # bumps wm._version
    edited = codec.wm_hp_device((H, W), wm)
    assert len(spectra) == 2 and not torch.equal(edited, first)
    assert torch.equal(edited, _fresh(codec, wm))
    wm[0, 0] -= 1.0  # back to the first plane's bytes: a content hit
    assert codec.wm_hp_device((H, W), wm) is first
    assert len(spectra) == 2


def test_another_frame_shape_misses(spectra):
    """120x250 frames take the same 16x32 plane as 128x256 frames."""
    codec, wm = DtcwtKey(backend="kernel"), _wm()
    assert codec.wm_capacity((120, 250, 3)) == codec.wm_capacity((H, W, 3))
    a = codec.wm_hp_device((H, W), wm)
    b = codec.wm_hp_device((120, 250), wm)
    assert len(spectra) == 2 and a is not b and torch.equal(a, b)


def test_an_inference_tensor_goes_to_the_content_cache(spectra):
    """An inference tensor has no version counter: no identity entry, so an
    in-place edit under inference mode cannot be missed."""
    codec = DtcwtKey(backend="kernel")
    with torch.inference_mode():
        wm = _wm()
        first = codec.wm_hp_device((H, W), wm)
        assert codec.wm_hp_device((H, W), wm) is first
        wm[0, 0] += 1.0
        edited = codec.wm_hp_device((H, W), wm)
    assert len(spectra) == 2 and not torch.equal(edited, first)
    assert not tcodecs._WM_ID_CACHE


def test_the_caches_hold_at_most_eight_entries(spectra):
    codec = DtcwtKey(backend="torch")
    planes = [_wm(key) for key in range(20)]
    for wm in planes:
        codec.wm_hp_device((H, W), wm)
        assert len(tcodecs._WM_HP_CACHE) <= 8 and len(tcodecs._WM_ID_CACHE) <= 8
    assert len(spectra) == 20
    last = codec.wm_hp_device((H, W), planes[-1])  # the newest entry is still there
    assert len(spectra) == 20 and torch.equal(last, _fresh(codec, planes[-1]))
    clear_wm_cache()
    assert not tcodecs._WM_HP_CACHE and not tcodecs._WM_ID_CACHE


def test_mark_frames_bytes_with_a_hit_a_miss_and_after_clearing_as_jax(spectra, rng):
    """One spectrum per distinct plane across mark calls; the marks are the
    same bytes whether the spectrum was cached or not, and within the JAX
    codec's tolerance of ``tests/test_torch_dtcwt.py``."""
    f = natural_frames(rng, 2, H, W)
    jax_codec = jcodecs.DtcwtKey(fast_dots=False)
    wm_np = jpimg.CorrShuffler(3).generate_wm(None, jax_codec.wm_capacity((H, W, 3)))
    want = np.asarray(jax_codec.mark_frames(jnp.asarray(f), jnp.asarray(wm_np)))
    codec, wm = DtcwtKey(backend="kernel"), torch.from_numpy(wm_np)
    miss = codec.mark_frames(torch.from_numpy(f), wm).numpy()
    hit = codec.mark_frames(torch.from_numpy(f), wm).numpy()
    content_hit = codec.mark_frames(torch.from_numpy(f), wm.clone()).numpy()
    assert len(spectra) == 1
    clear_wm_cache()
    cleared = codec.mark_frames(torch.from_numpy(f), wm).numpy()
    assert len(spectra) == 2
    for got in (hit, content_hit, cleared):
        np.testing.assert_array_equal(got, miss)
    d = np.abs(miss.astype(int) - want)
    assert (d == 0).mean() >= 0.995 and d.max() <= 1, ((d == 0).mean(), d.max())


def test_a_fresh_view_of_the_same_plane_hits_without_a_read_back(spectra, sync_sites):
    codec, wm = DtcwtKey(backend="kernel"), _wm()
    first = codec.wm_hp_device((H, W), wm)
    assert sync_sites == ["sync.wm_spectrum"]  # the first sight reads the plane back
    tcodecs._WM_HP_CACHE.clear()  # a hit below cannot come from the content cache
    with torch.inference_mode():  # as in a batch call
        views = [wm[None][0], wm[:], wm.view(wm.shape), *wm[None]]
    for view in views:
        assert view._base is wm and codec.wm_hp_device((H, W), view) is first
    assert sync_sites == ["sync.wm_spectrum"] and not tcodecs._WM_HP_CACHE
    assert len(spectra) == 1


def test_an_in_place_edit_through_a_view_misses(spectra, sync_sites):
    codec, wm = DtcwtKey(backend="kernel"), _wm()
    first = codec.wm_hp_device((H, W), wm[None][0])
    wm[None][0, 0, 0] += 1.0  # the base and every view share one version counter
    edited = codec.wm_hp_device((H, W), wm[None][0])
    assert sync_sites == ["sync.wm_spectrum"] * 2 and len(spectra) == 2
    assert not torch.equal(edited, first) and torch.equal(edited, _fresh(codec, wm))


def test_the_same_plane_at_another_place_in_its_base_misses(spectra):
    codec = DtcwtKey(backend="kernel")
    wms = torch.stack([_wm(0), _wm(1)])
    a, b = codec.wm_hp_device((H, W), wms[0]), codec.wm_hp_device((H, W), wms[1])
    assert len(spectra) == 2 and not torch.equal(a, b)
    assert torch.equal(b, _fresh(codec, wms[1]))


def test_two_calls_at_once_compute_a_new_planes_spectrum_once(spectra, monkeypatch):
    """``Embedder``'s two calls in flight meet a new plane together: one
    computes its spectrum, the other waits for it and gets the same one."""
    import threading
    import time

    codec, wm = DtcwtKey(backend="kernel"), _wm()
    counted = tcodecs._DtcwtBase.wm_highpass

    def slow(self, plane):
        time.sleep(0.2)  # long enough for the other thread to arrive
        return counted(self, plane)

    monkeypatch.setattr(tcodecs._DtcwtBase, "wm_highpass", slow)
    meet, got = threading.Barrier(2, timeout=30), []

    def call():
        meet.wait()
        with torch.inference_mode():
            got.append(codec.wm_hp_device((H, W), wm[None][0]))

    threads = [threading.Thread(target=call) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert len(spectra) == 1 and len(got) == 2 and got[0] is got[1]


def test_a_warm_batch_call_reaches_no_sync_site_of_the_codec(sync_sites, rng):
    """``FrameMarker.mark`` passes a fresh view of its plane on every call:
    after the first call no ``sync.wm_spectrum`` and no
    ``sync.constant_upload`` site is reached, and ``M_BWD[:, 1]`` sits on
    the device once, with its dtype and values."""
    clear_wm_cache()
    tcodecs._BWD_U.clear()
    codec = DtcwtKey(backend="kernel")
    marker = FrameMarker(codec, _wm().numpy(), 2, device="cpu")
    f = natural_frames(rng, 2, H, W)
    first = marker.mark(f)
    assert sync_sites == ["sync.wm_spectrum", "sync.constant_upload"]
    bwd = tcodecs._BWD_U[torch.device("cpu")]
    assert bwd.dtype == torch.float32 and torch.equal(bwd, torch.from_numpy(M_BWD[:, 1].copy()))
    for _ in range(2):
        np.testing.assert_array_equal(marker.mark(f), first)
    assert sync_sites == ["sync.wm_spectrum", "sync.constant_upload"]
    assert tcodecs._BWD_U[torch.device("cpu")] is bwd
    clear_wm_cache()


def test_multi_marker_computes_each_variant_spectrum_once(spectra, rng):
    """``mark_all`` passes a fresh view per variant and call: the identity
    cache finds the spectra of earlier calls."""
    codec = DtcwtKey(backend="kernel")
    wms = [_wm(key).numpy() for key in (0, 1, 2)]
    marker = MultiMarker(codec, wms, batch_size=2, device="cpu")
    f = natural_frames(rng, 2, H, W)
    first = marker.mark_all(f)
    assert len(spectra) == 3
    again = marker.mark_all(f)
    assert len(spectra) == 3
    np.testing.assert_array_equal(again, first)
    for v, wm in enumerate(wms):
        alone = DtcwtKey(backend="kernel").mark_frames(torch.from_numpy(f), torch.from_numpy(wm))
        np.testing.assert_array_equal(first[v], alone.numpy())
