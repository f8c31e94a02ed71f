"""Host <-> device transfers of the pipelines, and the handles that
``submit``/``collect`` pass between threads.

Upload: the frames are copied into a pinned staging buffer and sent to the
card by a non-blocking copy on a side stream, so the next batch's upload can
overlap the previous batch's download.  There is one staging buffer per
(device, batch shape) for the life of the process (``STAGING``): the HLS
marker builds a marker per segment, and pinning 100 MB for each would cost
more than the copy.  A buffer is refilled only once the event of its last
upload has completed.

Download: each result goes by a non-blocking copy into a fresh pinned
tensor from PyTorch's caching host allocator, which keeps a block out of
reuse until the copies recorded on it have completed.  The host array a
handle returns is that tensor's ``numpy()`` view, whose base keeps the
tensor alive: it stays valid for as long as a consumer holds it, however
many batches follow.  ``Pending.wait`` waits on the handle's own event,
never on a stream, so any thread may collect: the current stream is per
thread.  A device fault surfaces there, in the collecting thread.

On the CPU nothing is pinned and nothing is asynchronous: the work runs
when it is submitted and ``wait`` returns its result.

Spans (``utils/profiling.py``): ``transfer.stage_copy`` (the host copy and
padding, items = bytes), ``transfer.h2d_enqueue``, ``transfer.d2h_enqueue``,
and the two waits on the device, ``sync.stage_wait`` and
``sync.result_wait``.  A handle carries the batch id of the call that made
it, so its ``wait`` on another thread joins that batch.
"""

from __future__ import annotations

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
                host[:k] = frames
                host[k:] = frames[-1:]
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
                buf.array[:k] = frames
                buf.array[k:] = frames[-1:]
            with profiling.span("transfer.h2d_enqueue"), torch.cuda.stream(side):
                x = buf.host.to(device, non_blocking=True)
                buf.uploaded = side.record_event()
        compute.wait_event(buf.uploaded)
        x.record_stream(compute)  # allocated on the side stream, used on the caller's
        return x


STAGING = StagingPool()


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
        return Pending(out.numpy(), torch.cuda.current_stream(first.device).record_event(),
                       batch)
