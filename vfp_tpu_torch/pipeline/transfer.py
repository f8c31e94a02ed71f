"""Host <-> device transfers of the pipelines, and the handles that
``submit``/``collect`` pass between threads.

Upload: the frames are copied into a pinned staging buffer and sent to the
card by a non-blocking copy on a side stream, so the next batch's upload can
overlap the previous batch's download.  There is one staging buffer per
(device, batch shape) for the life of the process (``STAGING``): the HLS
marker builds a marker per segment, and pinning 100 MB for each would cost
more than the copy.  A buffer is refilled only once the event of its last
upload has completed.  ``Embedder`` keeps two batch calls in flight, which
share the buffer: the second call's host copy starts once the first's H2D
has read the buffer.  A second buffer per shape would let that copy run
during the H2D, but both draw on the host's memory bandwidth, and on an
H100 host the cell marked slower with two buffers than with one (PERF.md,
section 6).

Download: each result goes by a non-blocking copy into a fresh pinned
tensor from PyTorch's caching host allocator, which keeps a block out of
reuse until the copies recorded on it have completed.  The host array a
handle returns is that tensor's ``numpy()`` view, whose base keeps the
tensor alive: it stays valid for as long as a consumer holds it, however
many batches follow.  ``Pending.wait`` waits on the handle's own event,
never on a stream, so any thread may collect: the current stream is per
thread.  The events of both waits are blocking ones: the waiting thread
sleeps rather than spins.  A device fault surfaces there, in the
collecting thread.

The host copy into the staging buffer is split across host threads.  The
``k`` rows and the padding rows are one flat byte range of the buffer, cut
at 4 KiB boundaries into equal contiguous pieces of at least 4 MiB, which
``min(cores, bytes // 4 MiB, 8)`` threads copy (``cores``: the CPUs the
process may run on): the calling thread and daemon workers of one pool per
process, started at the first upload that fans out.  The pieces are dealt
one at a time to whichever thread asks next, so a worker that the host
schedules late holds up nothing.  Each upload waits for its own pieces
only, so uploads from several threads share the pool.  With fewer than 2
threads, or a source that is not C-contiguous, the calling thread copies
alone.  The workers never touch CUDA: the H2D is enqueued once every piece
has landed.

On the CPU nothing is pinned and nothing is asynchronous: the work runs
when it is submitted and ``wait`` returns its result.  The host copy is
the same split copy.

Spans (``utils/profiling.py``): ``transfer.stage_copy`` (the host copy and
padding, items = bytes), inside it ``transfer.stage_fanout`` where the copy
fans out (items = threads; the workers open no span),
``transfer.h2d_enqueue``, ``transfer.d2h_enqueue``, and the two waits on
the device, ``sync.stage_wait`` and ``sync.result_wait``.  A handle
carries the batch id of the call that made it, so its ``wait`` on another
thread joins that batch.
"""

from __future__ import annotations

import os
import queue
import threading
from dataclasses import dataclass

import numpy as np
import torch

from ..utils import profiling


@dataclass
class Pending:
    """A host result, the event after which it is complete (None: it
    already is) and the batch id of its span (None while nothing records)."""

    out: np.ndarray
    done: torch.cuda.Event | None = None
    batch: int | None = None

    def wait(self) -> np.ndarray:
        if self.done is not None:
            with profiling.span("sync.result_wait", batch=self.batch):
                self.done.synchronize()
        return self.out


# Chosen on an H100 machine's host (8 vCPUs; PERF.md, section 6).  A 1080p
# B=16 batch (99.5 MB) out of a 64-frame pool into the pinned buffer took
# 22.7 ms on one thread, 13.0 on 2, 9.0 on 4 and 7.5 on 8, so the cap is the
# host's 8 cores.  Pieces under 1 MiB made a copy slower, pieces of 1-2 MiB
# did not gain on every host, pieces of 4 MiB did (1.18-1.51x at 8 MiB).
PIECE_FLOOR = 4 << 20  # bytes
FANOUT_CAP = 8  # threads
_ALIGN = 4096  # piece edges, in bytes


def _fill(flat: np.ndarray, src: np.ndarray, last: np.ndarray, a: int, b: int) -> None:
    """``flat[a:b]`` of a padded batch: the elements of ``src``, then copies
    of ``last`` (the last row) up to the end of ``flat``."""
    n = src.size
    if a < n:
        np.copyto(flat[a:min(b, n)], src[a:min(b, n)])
        a = n
    while a < b:
        r = (a - n) % last.size  # where ``a`` falls in its padding row
        m = min(b - a, last.size - r)
        np.copyto(flat[a:a + m], last[r:r + m])
        a += m


class _Copy:
    """One staging copy cut into pieces, dealt one at a time to whichever
    thread asks next: a thread that the host has not scheduled yet holds up
    no piece, and one that stalls holds up only the piece it has."""

    def __init__(self, flat, src, last, edges):
        self.flat, self.src, self.last, self.edges = flat, src, last, edges
        self._lock = threading.Lock()
        self._dealt = 0
        self._left = len(edges) - 1
        self.error: Exception | None = None
        self.landed = threading.Event()  # set once every piece is in the buffer

    def run(self) -> None:
        """Copy pieces until none is left to deal."""
        while True:
            with self._lock:
                i = self._dealt
                self._dealt += 1
            if i >= len(self.edges) - 1:
                return
            try:
                _fill(self.flat, self.src, self.last, self.edges[i], self.edges[i + 1])
            except Exception as e:  # raised again in the upload that waits for it
                self.error = self.error or e
            finally:
                with self._lock:
                    self._left -= 1
                    if self._left == 0:
                        self.landed.set()


class _Fanout:
    """The staging copy split over host threads: the fan-out rule and a pool
    of daemon workers that copy pieces and never touch CUDA."""

    def __init__(self):
        self.cores = len(os.sched_getaffinity(0))
        self._lock = threading.Lock()
        self._tasks: queue.SimpleQueue | None = None
        self._pid = None

    def threads(self, nbytes: int) -> int:
        return min(self.cores, nbytes // PIECE_FLOOR, FANOUT_CAP)

    def _queue(self) -> queue.SimpleQueue:
        with self._lock:
            if self._pid != os.getpid():  # first use, or a forked child, which has no workers
                self._tasks = queue.SimpleQueue()
                for i in range(min(self.cores, FANOUT_CAP) - 1):
                    threading.Thread(target=_work, args=(self._tasks,), daemon=True,
                                     name=f"vfp-stage-copy-{i}").start()
                self._pid = os.getpid()
            return self._tasks

    def stage(self, dst: np.ndarray, frames: np.ndarray) -> None:
        """Fill ``dst`` [B, ...] with ``frames`` [k, ...] and copies of its
        last row."""
        k = len(frames)
        n = self.threads(dst.nbytes) if frames.flags.c_contiguous else 1
        if n < 2:
            dst[:k] = frames
            dst[k:] = frames[-1:]
            return
        with profiling.span("transfer.stage_fanout", n):
            flat = dst.reshape(-1)
            pieces, step = dst.nbytes // PIECE_FLOOR, _ALIGN // dst.itemsize
            edges = [i * flat.size // pieces // step * step for i in range(pieces)] + [flat.size]
            copy = _Copy(flat, frames.reshape(-1), frames[-1].reshape(-1), edges)
            tasks = self._queue()
            for _ in range(n - 1):
                tasks.put(copy)
            try:
                copy.run()
            finally:  # no piece may still be landing once the buffer is handed on
                copy.landed.wait()
            if copy.error is not None:
                raise copy.error


def _work(tasks: queue.SimpleQueue) -> None:
    while True:
        copy = tasks.get()
        copy.run()
        del copy  # hold no batch while idle


class _Staging:
    def __init__(self, shape, dtype: torch.dtype):
        self.host = torch.empty(shape, dtype=dtype, pin_memory=True)
        self.array = self.host.numpy()
        self.uploaded: torch.cuda.Event | None = None  # after its last H2D copy
        self.lock = threading.Lock()


class StagingPool:
    """Pinned staging buffers, one per (device, shape, dtype), and one upload
    stream per device."""

    def __init__(self):
        self._lock = threading.Lock()
        self._buffers: dict = {}
        self._streams: dict = {}
        self._fanout = _Fanout()

    def _get(self, device: torch.device, shape, dtype: torch.dtype):
        with self._lock:
            buf = self._buffers.get((device, shape, dtype))
            if buf is None:
                buf = self._buffers[(device, shape, dtype)] = _Staging(shape, dtype)
            if device not in self._streams:
                self._streams[device] = torch.cuda.Stream(device)
            return buf, self._streams[device]

    def upload(self, frames: np.ndarray, batch_size: int, device: torch.device) -> torch.Tensor:
        """[k, ...] -> [max(batch_size, k), ...] of the same dtype on
        ``device``, padded with copies of the last row so every batch has one
        shape (the frame batches [k, H, W, 3] u8; the LL transport's [k, hc,
        wc] u8 or f16 with ``batch_size=k``, unpadded).  On CUDA the result
        is ready for work enqueued after it on the caller's current stream."""
        k = len(frames)
        shape = (max(batch_size, k), *frames.shape[1:])
        if device.type != "cuda":
            host = np.empty(shape, frames.dtype)
            with profiling.span("transfer.stage_copy", host.nbytes):
                self._fanout.stage(host, frames)
            with profiling.span("transfer.h2d_enqueue"):
                return torch.from_numpy(host).to(device)
        dtype = torch.from_numpy(frames[:0]).dtype
        buf, side = self._get(device, shape, dtype)
        compute = torch.cuda.current_stream(device)
        with buf.lock:
            if buf.uploaded is not None:
                with profiling.span("sync.stage_wait"):
                    buf.uploaded.synchronize()
            with profiling.span("transfer.stage_copy", buf.array.nbytes):
                self._fanout.stage(buf.array, frames)
            with profiling.span("transfer.h2d_enqueue"), torch.cuda.stream(side):
                x = buf.host.to(device, non_blocking=True)
                uploaded = buf.uploaded = _record(side)
        compute.wait_event(uploaded)  # this upload's, whatever another thread records next
        x.record_stream(compute)  # allocated on the side stream, used on the caller's
        return x


STAGING = StagingPool()


def _record(stream: torch.cuda.Stream) -> torch.cuda.Event:
    """An event recorded on ``stream`` whose ``synchronize`` sleeps until it
    has passed.  A spinning wait would hold a core that the staging copy and
    the other batch call in flight need (PERF.md, section 6)."""
    event = torch.cuda.Event(blocking=True)
    event.record(stream)
    return event


def upload_batch(frames: np.ndarray, batch_size: int, device: torch.device) -> torch.Tensor:
    """``STAGING.upload``: the frames on ``device`` as one padded batch."""
    return STAGING.upload(frames, batch_size, torch.device(device))


def download(results, k: int) -> Pending:
    """Start copying the first ``k`` rows of each device result [B, ...] into
    one host array [len(results), k, ...]; on the CPU, copy them now."""
    first = results[0]
    batch = profiling.current_batch()
    with profiling.span("transfer.d2h_enqueue"):
        if not first.is_cuda:
            return Pending(torch.stack([r[:k] for r in results]).numpy(), batch=batch)
        out = torch.empty((len(results), k, *first.shape[1:]), dtype=first.dtype,
                          pin_memory=True)
        for dst, r in zip(out, results):
            dst.copy_(r[:k], non_blocking=True)
        return Pending(out.numpy(), _record(torch.cuda.current_stream(first.device)), batch)
