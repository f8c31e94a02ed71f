"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a card, drives the rest of a run
on the CPU at a tiny size, and plants one fault in the program's batch
call: the work returned undone, half of the batch left out, or an answer
altered where it is produced.  (The cells run on one chip: there is no
exchange between chips to leave out.)"""

import time

import numpy as np
import pytest

from conftest import LEAK
from harness import runner

MARK_CELLS = ["flagship_1080p30.hls_variants", "dtcwtKey_1080p30.title_mark",
              "flagship_1080p30.title_mark"]


def _undone(frames, out):
    return np.broadcast_to(frames, out.shape).copy()


def _half(frames, out):
    out = out.copy()
    out[..., len(frames) // 2:, :, :, :] = frames[len(frames) // 2:]
    return out


def _altered(frames, out):
    out = out.copy()
    out[..., 0, 0, 0] = (out[..., 0, 0, 0].astype(np.int16) + 64) % 256
    return out


FAULTS = {"work_undone": _undone, "half_batch_left_out": _half, "answer_altered": _altered}


def _plant(monkeypatch, fault):
    from vfp_tpu_torch.pipeline import embedder

    mark, collect = embedder.FrameMarker.mark, embedder.MultiMarker.collect

    def bad_mark(self, frames):
        return fault(frames, mark(self, frames))

    submit = embedder.MultiMarker.submit

    def spy_submit(self, frames):  # the handle carries its own frames
        return submit(self, frames), np.asarray(frames)

    def bad_collect(self, item):
        handle, frames = item
        return fault(frames, collect(self, handle))

    monkeypatch.setattr(embedder.FrameMarker, "mark", bad_mark)
    monkeypatch.setattr(embedder.MultiMarker, "submit", spy_submit)
    monkeypatch.setattr(embedder.MultiMarker, "collect", bad_collect)


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", MARK_CELLS)
def test_a_broken_mark_is_not_correct(load_tiny, monkeypatch, name, fault):
    cell = load_tiny(name)
    cell.traffic["check_frames"] = 16  # a sample that meets both halves of the batches
    _plant(monkeypatch, FAULTS[fault])
    res = runner.execute(cell, 2**31 + 9, 0.3, False, "cpu", time.perf_counter_ns(),
                         log=lambda m: None)
    assert res["correct"] is False, res["check"]


def _bad_payloads(kind):
    def fault(frames, out):
        out = out.copy()
        if kind == "work_undone":
            return np.zeros_like(out)
        if kind == "half_batch_left_out":
            return out[: len(out) // 2]
        out[:, 0] ^= 1
        return out
    return fault


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_extract_is_not_correct(load_tiny, monkeypatch, fault):
    from vfp_tpu_torch.pipeline import extractor

    extract = extractor.FrameExtractor.extract
    bad = _bad_payloads(fault)
    monkeypatch.setattr(extractor.FrameExtractor, "extract",
                        lambda self, frames: bad(frames, extract(self, frames)))
    extractor._cached_bit_extractor.cache_clear()
    res = runner.execute(load_tiny(LEAK), 2**31 + 9, 0.3, False,
                         "cpu", time.perf_counter_ns(), log=lambda m: None)
    assert res["correct"] is False, res["check"]
