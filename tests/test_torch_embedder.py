"""``Embedder`` (``pipeline/embedder.py``) with two calls of its marker in
flight, on the CPU: a marker that has only ``mark`` and ``batch_size``, as
the benchmark's driver hands it one, runs two calls at once and never more;
the writer gets the batches in input order whatever each call takes; an
error in the first or the second call in flight is raised by ``start``
once every thread it started has ended; and ``FrameMarker``'s LL route
takes one call at a time.  Each test runs ``start`` on a thread of its own
and gives it a time limit.
"""

import threading
import time

import numpy as np
import pytest
import torch

from vfp_tpu_torch.io import ArrayReader, ArrayWriter
from vfp_tpu_torch.pipeline import Embedder, FrameMarker, embedder
from vfp_tpu_torch.wm import CorrShuffler, DtcwtKey, DwtDctSvd, Shuffler

from torch_parity import PAYLOAD, natural_frames

torch.set_num_threads(1)

H, W = 64, 96
LIMIT_S = 60  # each start() must end within this


def _start(emb: Embedder):
    """``emb.start()`` on its own thread, within ``LIMIT_S``: (stats, error)."""
    out = {}

    def run():
        try:
            out["stats"] = emb.start()
        except Exception as e:  # returned to the test
            out["error"] = e

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=LIMIT_S)
    assert not t.is_alive(), "Embedder.start did not end in time"
    return out.get("stats"), out.get("error")


def _mark_threads():
    return [t for t in threading.enumerate() if t.name.startswith("vfp-mark")]


class MarkOnly:
    """What the benchmark's driver hands ``Embedder``: ``mark`` around a
    marker, and its ``batch_size``; counts the calls running at once."""

    def __init__(self, marker, meet: int = 0):
        self.marker = marker
        self.batch_size = marker.batch_size
        self._lock = threading.Lock()
        self._running = 0
        self.most = 0
        # the first ``meet`` calls wait for each other: a serial driver would
        # leave the first waiting until the barrier breaks
        self._meet = threading.Barrier(meet, timeout=20) if meet else None
        self._calls = 0

    def mark(self, frames):
        with self._lock:
            self._running += 1
            self.most = max(self.most, self._running)
            first = self._calls < 2
            self._calls += 1
        try:
            if first and self._meet is not None:
                self._meet.wait()
            return self.marker.mark(frames)
        finally:
            with self._lock:
                self._running -= 1


def test_a_mark_only_marker_gets_two_calls_at_once():
    codec = DtcwtKey()
    wm = CorrShuffler(key=0).generate_wm(None, codec.wm_capacity((H, W, 3)))
    inner = FrameMarker(codec, wm, 3, device="cpu")
    frames = natural_frames(np.random.RandomState(5), 11, H, W)
    marker, writer = MarkOnly(inner, meet=2), ArrayWriter()
    stats, error = _start(Embedder(ArrayReader(frames), marker, writer, prefetch=1))
    assert error is None and stats.frames == 11
    assert marker.most == embedder.IN_FLIGHT == 2
    want = np.concatenate([inner.mark(frames[i:i + 3]) for i in range(0, 11, 3)])
    np.testing.assert_array_equal(writer.frames, want)
    assert not _mark_threads()


class Jittery:
    """A marker whose calls take a seeded random time: the batch reversed
    along its width and inverted, so each output names its input."""

    batch_size = 3

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.lock = threading.Lock()

    def mark(self, frames):
        with self.lock:
            pause = float(self.rng.uniform(0.0, 0.02))
        time.sleep(pause)
        return 255 - frames[:, :, ::-1]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_batches_reach_the_writer_in_input_order(seed):
    frames = np.random.default_rng(seed).integers(0, 256, (40, 8, 12, 3), dtype=np.uint8)
    marker, writer = Jittery(seed), ArrayWriter()
    stats, error = _start(Embedder(ArrayReader(frames), marker, writer))
    assert error is None and stats.frames == 40
    serial = np.concatenate([marker.mark(frames[i:i + 3]) for i in range(0, 40, 3)])
    assert writer.frames.shape == serial.shape
    np.testing.assert_array_equal(writer.frames, serial)


class FailsOnce:
    """Raises in call ``bad``; call 0 takes a while, so that a failing call
    1 ends while call 0 is still in flight."""

    batch_size = 2

    def __init__(self, bad: int):
        self.bad = bad
        self.calls = 0
        self.lock = threading.Lock()

    def mark(self, frames):
        with self.lock:
            i = self.calls
            self.calls += 1
        if i == 0:
            time.sleep(0.2)
        if i == self.bad:
            raise RuntimeError(f"call {i} failed")
        return frames


@pytest.mark.parametrize("bad", [0, 1])
def test_an_error_in_either_call_in_flight_is_raised_once_every_thread_ends(bad):
    frames = np.arange(20 * 4 * 4 * 3, dtype=np.uint32).astype(np.uint8).reshape(20, 4, 4, 3)
    before = set(threading.enumerate())
    writer = ArrayWriter()
    stats, error = _start(Embedder(ArrayReader(frames), FailsOnce(bad), writer, prefetch=1))
    assert stats is None and isinstance(error, RuntimeError)
    assert str(error) == f"call {bad} failed"
    # the batches before the failing one are written, in order, and no later one
    np.testing.assert_array_equal(writer.frames.reshape(-1, 4, 4, 3), frames[:2 * bad])
    assert set(threading.enumerate()) <= before and not _mark_threads()


def test_the_ll_route_takes_one_call_at_a_time(monkeypatch):
    monkeypatch.setenv("VFP_LOWLINK", "1")
    monkeypatch.delenv("VFP_LL_WIRE", raising=False)
    frames = natural_frames(np.random.RandomState(6), 10, H, W)
    wm = Shuffler(key=0).generate_wm(PAYLOAD, (1, H * W // 64))
    marker = FrameMarker(DwtDctSvd(), wm, 2, device="cpu")
    assert marker._ll is not None
    mark_all = marker._ll.mark_all
    running, most, lock = [0], [0], threading.Lock()

    def counted(batch):
        with lock:
            running[0] += 1
            most[0] = max(most[0], running[0])
        try:
            time.sleep(0.01)
            return mark_all(batch)
        finally:
            with lock:
                running[0] -= 1

    monkeypatch.setattr(marker._ll, "mark_all", counted)
    writer = ArrayWriter()
    stats, error = _start(Embedder(ArrayReader(frames), marker, writer))
    assert error is None and stats.frames == 10 and most[0] == 1
    want = np.concatenate([mark_all(frames[i:i + 2])[0] for i in range(0, 10, 2)])
    np.testing.assert_array_equal(writer.frames, want)
