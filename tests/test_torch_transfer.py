"""The staging copy of ``StagingPool.upload`` (``pipeline/transfer.py``) on
the CPU, where it runs the same split copy as on a card: the padded batch
equal to a plain concatenation whether the copy fans out or stays inline,
``transfer.stage_fanout`` exactly where the fan-out rule says so, the rule
itself, a copy that completes with no worker scheduled, two threads
sharing the workers, at one shape or two, and a worker's error
raised in the upload that waits for it.  On the CPU an upload stages into
a fresh array, so the card's uploads through the staging buffer that
calls share are held by ``tests/test_torch_cuda.py``.
"""

import os
import queue
import sys
import threading

import numpy as np
import pytest
import torch

from vfp_tpu_torch.pipeline import transfer
from vfp_tpu_torch.utils.profiling import record_spans

CPU = torch.device("cpu")
CORES = 8  # the CPUs the pools below are told they may use


def _pool(cores=CORES) -> transfer.StagingPool:
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(os, "sched_getaffinity", lambda pid: set(range(cores)))
        return transfer.StagingPool()


@pytest.fixture(scope="module")
def pool():
    return _pool()


def _batch(shape, dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype == np.uint8:
        return rng.integers(0, 256, shape, dtype=np.uint8)
    return rng.standard_normal(shape, dtype=np.float32).astype(dtype)


def _padded(frames, batch_size):
    return np.concatenate([frames, np.repeat(frames[-1:], batch_size - len(frames), axis=0)])


CASES = {  # name: (shape of the frames, dtype, batch size)
    "full_1080p": ((16, 1080, 1920, 3), np.uint8, 16),
    "short_1080p": ((5, 1080, 1920, 3), np.uint8, 16),  # 11 padding rows inside the pieces
    "bytes_not_4k": ((16, 1080, 1918, 3), np.uint8, 16),  # 99,429,120 B: 4 KiB leaves 2,816
    "short_not_4k": ((7, 1078, 1918, 3), np.uint8, 16),
    "ll_wire_f16": ((16, 16, 32400), np.float16, 16),  # the LL transport's f16 wire
    "small_inline": ((3, 64, 96, 3), np.uint8, 4),
}


@pytest.mark.parametrize("case", list(CASES))
def test_upload_equals_the_padded_batch(pool, case):
    shape, dtype, bs = CASES[case]
    frames = _batch(shape, dtype, seed=len(case))
    want = _padded(frames, bs)
    with record_spans() as spans:
        got = pool.upload(frames, bs, CPU).numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)
    n = min(CORES, want.nbytes // transfer.PIECE_FLOOR, transfer.FANOUT_CAP)
    (copy,) = [s for s in spans if s.name == "transfer.stage_copy"]
    fans = [s for s in spans if s.name == "transfer.stage_fanout"]
    assert copy.items == want.nbytes
    if n >= 2:
        (fan,) = fans
        assert (fan.items, fan.parent, fan.thread) == (n, copy.id, copy.thread)
        assert copy.t0 <= fan.t0 <= fan.t1 <= copy.t1
    else:
        assert case == "small_inline" and fans == []


def test_a_source_that_is_not_contiguous_is_copied_inline(pool):
    rgb = _batch((9, 1080, 1920, 3), np.uint8, seed=3)[..., ::-1]  # a channel-flipped view
    with record_spans() as spans:
        got = pool.upload(rgb, 16, CPU).numpy()
    assert np.array_equal(got, _padded(rgb, 16))
    assert [s.name for s in spans] == ["transfer.stage_copy", "transfer.h2d_enqueue"]


@pytest.mark.parametrize("cores, nbytes, threads", [
    (8, 99_532_800, 8), (16, 99_532_800, 8), (4, 99_532_800, 4), (2, 99_532_800, 2),
    (1, 99_532_800, 1), (8, 16_588_800, 3), (8, 8_294_400, 1), (8, 73_728, 0)])
def test_fanout_rule_takes_the_cores_the_bytes_and_the_cap(cores, nbytes, threads):
    """``min(cores, bytes // 4 MiB, 8)``: one 1080p batch, the LL transport's
    f16 and u8 wires, a small batch."""
    assert (transfer.PIECE_FLOOR, transfer.FANOUT_CAP) == (4 << 20, 8)
    assert _pool(cores)._fanout.threads(nbytes) == threads


def test_the_caller_copies_every_piece_that_no_worker_takes(monkeypatch):
    """Workers the host never schedules hold up nothing: the calling thread
    takes every piece that is still to be dealt."""
    fanout = _pool()._fanout
    monkeypatch.setattr(fanout, "_queue", queue.SimpleQueue)  # a queue no worker reads
    frames = _batch((7, 1080, 1920, 3), np.uint8, seed=6)
    dst = np.empty((16, 1080, 1920, 3), np.uint8)
    t = threading.Thread(target=fanout.stage, args=(dst, frames))
    t.start()
    t.join(timeout=60)
    assert not t.is_alive() and np.array_equal(dst, _padded(frames, 16))


def _upload_together(pool, shapes):
    """Two threads start uploading together, back to back with no wait
    between their calls, of different content; each gets its own bytes."""
    for shape, dtype, bs in shapes.values():  # both fan out
        assert pool._fanout.threads(bs * np.prod(shape[1:]) * np.dtype(dtype).itemsize) >= 2
    results, errors = {}, []
    meet = threading.Barrier(2, timeout=30)

    def run(name):
        shape, dtype, bs = shapes[name]
        try:
            meet.wait()
            for seed in range(6):
                frames = _batch(shape, dtype, seed=seed + 10 * len(name))
                results[name, seed] = np.array_equal(pool.upload(frames, bs, CPU).numpy(),
                                                     _padded(frames, bs))
        except Exception as e:  # reported below, in the test's thread
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=run, args=(name,)) for name in shapes]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads) and errors == []
    assert len(results) == 12 and all(results.values())


def test_two_threads_uploading_at_once_get_their_own_bytes(pool):
    _upload_together(pool, {"frames": ((5, 720, 1280, 3), np.uint8, 8),
                            "wire": ((16, 16, 32400), np.float16, 16)})


def test_two_threads_uploading_one_shape_at_once_get_their_own_bytes(pool):
    """As the two calls ``Embedder`` keeps in flight upload."""
    _upload_together(pool, {"one": ((16, 720, 1280, 3), np.uint8, 16),  # names of two
                            "other": ((16, 720, 1280, 3), np.uint8, 16)})  # lengths: two seeds


def test_a_workers_error_is_raised_in_its_upload(pool, monkeypatch):
    fill = transfer._fill

    def failing(flat, src, last, a, b):
        if a > 0:  # every piece but the first
            raise ValueError("piece failed")
        fill(flat, src, last, a, b)

    frames = _batch((16, 720, 1280, 3), np.uint8, seed=5)
    with monkeypatch.context() as mp:
        mp.setattr(transfer, "_fill", failing)
        with pytest.raises(ValueError, match="piece failed"):
            pool.upload(frames, 16, CPU)
    assert np.array_equal(pool.upload(frames, 16, CPU).numpy(), frames)  # the pool still works
