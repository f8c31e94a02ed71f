"""The frozen plain reference agrees with vfp_tpu_torch's plain paths at a
small size (the tests may import the program; the reference may not)."""

import numpy as np
import pytest
import torch

from harness import frames as content
from reference import dtcwt_key, flagship, spread

PAYLOAD = np.array([0, 1, 1, 0, 0, 1, 0, 1])


def _frames(kind, n, h, w, seed=2**32 + 3):
    return content.make(kind, content.generator(seed, "cpu"), n, h, w, "cpu")


def test_spreading_equals_the_programs():
    from vfp_tpu_torch.fingerprint.payloads import payload_for_segment
    from vfp_tpu_torch.wm import CorrShuffler, DeShuffler, Shuffler

    for s in (0, 5, 17):
        for c in range(3):
            assert (spread.segment_payload(s, c) == payload_for_segment(s, c)).all()
    plane = spread.spread_bits(PAYLOAD, 0, 96)
    assert (plane == Shuffler(0).generate_wm(PAYLOAD, (1, 96)).reshape(-1)).all()
    noisy = np.stack([plane, 1 - plane, plane])
    noisy[0, :5] = 1 - noisy[0, :5]
    ours = spread.despread_bits(noisy, 0, 8)
    theirs = DeShuffler(0, threshold="fixed").set_shape((8,)).degenerate_batch(
        torch.from_numpy(noisy.astype(np.float32))).numpy()
    assert (ours == theirs).all()
    for size in ((136, 240), (8, 12)):
        assert np.array_equal(spread.key_plane(0, size), CorrShuffler(0).generate_wm(None, size))


@pytest.mark.parametrize("hw", [(64, 96), (120, 200)])
def test_flagship_mark_agrees_with_the_tensor_path(hw):
    from vfp_tpu_torch.wm import DwtDctSvd

    h, w = hw
    fr = _frames("natural", 4, h, w)
    wm = flagship.make_watermark(PAYLOAD, 0, h, w)
    ours = flagship.mark(torch.from_numpy(fr), wm).numpy().astype(int)
    theirs = DwtDctSvd(backend="torch").mark_frames(torch.from_numpy(fr),
                                                     torch.from_numpy(wm)).numpy()
    d = np.abs(ours - theirs)
    # the tensor path's triplet (5 power squarings) and LAPACK's SVD differ
    # in the last bits of s0: a rounding step on a few bytes
    assert d.max() <= 1 and np.count_nonzero(d) / d.size < 1e-4


def test_flagship_decode_recovers_the_payload():
    h, w = 64, 96
    fr = _frames("natural", 3, h, w)
    marked = flagship.mark(torch.from_numpy(fr), flagship.make_watermark(PAYLOAD, 0, h, w))
    planes = flagship.decode(marked).numpy()
    assert (spread.despread_bits(planes, 0, 8) == PAYLOAD).all()


@pytest.mark.parametrize("hw", [(64, 96), (128, 200)])
def test_dtcwt_key_mark_equals_the_tensor_path(hw):
    from vfp_tpu_torch.wm import DtcwtKey

    h, w = hw
    fr = _frames("smooth", 3, h, w)
    wm = dtcwt_key.make_watermark(None, 0, h, w)
    ours = dtcwt_key.mark(torch.from_numpy(fr), wm).numpy()
    theirs = DtcwtKey(backend="torch").mark_frames(torch.from_numpy(fr),
                                                    torch.from_numpy(wm)).numpy()
    assert np.array_equal(ours, theirs)
    assert np.abs(ours.astype(int) - fr).mean() > 1  # the mark is there


def test_dtcwt_plane_size_matches_the_codecs_capacity():
    from vfp_tpu_torch.wm import DtcwtKey

    for hw in ((1080, 1920), (64, 96), (804, 1920)):
        assert dtcwt_key.plane_size(*hw) == tuple(DtcwtKey().wm_capacity((*hw, 3)))
