"""Embedding pipeline: reader -> batched device mark -> writer, stages overlapped
(port of ``vfp_tpu/pipeline/embedder.py``).

Frames move in ``[B, H, W, 3]`` batches; a reader thread decodes ahead and
a writer thread encodes batch k-1 while two calls of the marker are in
flight, each on a thread of its own: batch k's call waits on the device
while batch k+1's stages its upload and enqueues its work.  Every class
takes the device it runs on.  With ``VFP_LOWLINK=1`` (or
``VFP_LL_WIRE=host``) the flagship codec's markers move LL-band data instead
of frames (``lowlink.py``; ``use_lowlink``).

``MultiMarker.submit`` enqueues a batch's upload, marks and downloads and
returns a handle; ``collect`` waits on that handle alone, so the writer
thread of ``fingerprint.marker`` collects while the next batches are
submitted (transfers: ``transfer.py``).

Spans (``utils/profiling.py``): ``marker.mark``, ``marker.submit`` and
``marker.collect`` around the batch calls (items = frames; ``mark`` and
``submit`` take a new batch id, ``collect`` joins its handle's),
``codec.mark`` around the codec's enqueue of each variant's mark, and
``embedder.read_wait`` / ``embedder.write_wait`` where ``Embedder``'s loop
blocks on its queues, from the clock reads its ``stage_seconds`` sums.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

from ..utils import profiling
from .lowlink import LowLinkMarker, default_wire, lowlink_ok
from .transfer import Pending, download, upload_batch

logger = logging.getLogger(__name__)

_SENTINEL = None
IN_FLIGHT = 2  # the marker's calls that ``Embedder`` keeps going at once


def use_lowlink(codec) -> bool:
    """The LL-domain transport's policy (``lowlink.py``), the JAX package's
    rule: ``VFP_LOWLINK=0`` turns it off; a codec it does not apply to stays
    off; ``VFP_LOWLINK=1`` or ``VFP_LL_WIRE=host`` turns it on; otherwise
    it is off, as the JAX package has it everywhere but on a TPU."""
    flag = os.environ.get("VFP_LOWLINK", "auto")
    if flag == "0" or not lowlink_ok(codec):
        return False
    return flag == "1" or default_wire() == "host"


class FrameMarker:
    """Binds a codec + spread watermark into a uint8 batch transform on
    ``device``; through the LL transport where ``use_lowlink`` says so.
    ``mark`` may be called from several threads at once; the LL route runs
    one call at a time."""

    def __init__(self, codec, wm: np.ndarray, batch_size: int = 16, *, device):
        self.codec = codec
        self.device = torch.device(device)
        self.batch_size = batch_size
        wm = np.asarray(wm, np.float32).reshape(-1)
        self._ll = (LowLinkMarker(codec, [wm], batch_size, device=self.device)
                    if use_lowlink(codec) else None)
        # the host wire makes no CUDA call, so nothing is placed on the device
        self.wm = None if self._ll is not None else torch.as_tensor(wm, device=self.device)
        self._ll_lock = threading.Lock()

    def mark(self, frames: np.ndarray) -> np.ndarray:
        """[k, H, W, 3] -> [k, H, W, 3] uint8."""
        with profiling.span("marker.mark", len(frames), batch=profiling.NEW_BATCH):
            if self._ll is not None:
                with self._ll_lock:
                    return self._ll.mark_all(frames)[0]
            return _submit_marks(self.codec, frames, self.wm[None], self.batch_size,
                                 self.device).wait()[0]


class MultiMarker:
    """Marks every watermark variant of each frame batch (the HLS copies);
    the frames are uploaded once per batch.  Through the LL transport where
    ``use_lowlink`` says so, with device calls packed across markers by a
    shared ``packer`` (``lowlink.PackedTwoPlane``) for 3 or more variants."""

    def __init__(self, codec, wms, batch_size: int = 16, packer=None, *, device):
        self.codec = codec
        self.device = torch.device(device)
        self.batch_size = batch_size
        wms = np.stack([np.asarray(w, np.float32).reshape(-1) for w in wms])
        self._ll = (LowLinkMarker(codec, wms, batch_size, packer=packer, device=self.device)
                    if use_lowlink(codec) else None)
        self.wms = None if self._ll is not None else torch.as_tensor(wms, device=self.device)
        self._n = len(wms)

    @property
    def n_variants(self) -> int:
        return self._n

    def submit(self, frames: np.ndarray):
        """Enqueue the upload, every variant's mark and the downloads, and
        return without waiting on the device (on the CPU: mark now)."""
        with profiling.span("marker.submit", len(frames), batch=profiling.NEW_BATCH):
            if self._ll is not None:
                return self._ll.submit(frames)
            return _submit_marks(self.codec, frames, self.wms, self.batch_size, self.device)

    def collect(self, handle) -> np.ndarray:
        """[V, k, H, W, 3] uint8 of a ``submit``, once its event has passed."""
        if self._ll is not None:  # the LL transport's handles carry no batch id
            with profiling.span("marker.collect"):
                return self._ll.collect(handle)
        with profiling.span("marker.collect", handle.out.shape[1], batch=handle.batch):
            return handle.wait()

    def mark_all(self, frames: np.ndarray) -> np.ndarray:
        """[k, H, W, 3] -> [V, k, H, W, 3] uint8."""
        return self.collect(self.submit(frames))


@torch.inference_mode()
def _submit_marks(codec, frames: np.ndarray, wms: torch.Tensor, batch_size: int,
                  device: torch.device) -> Pending:
    """One upload of the batch, one mark per watermark, each variant
    downloaded into its slice of one host array [V, k, H, W, 3]."""
    x = upload_batch(frames, batch_size, device)
    marked = []
    for wm in wms:
        with profiling.span("codec.mark", len(x)):
            marked.append(codec.mark_frames(x, wm))
    return download(marked, len(frames))


@dataclass
class PipelineStats:
    frames: int = 0
    seconds: float = 0.0
    stage_seconds: dict = field(default_factory=dict)

    @property
    def fps(self) -> float:
        return self.frames / self.seconds if self.seconds else 0.0


class Embedder:
    """Drive reader -> marker -> writer to completion (reference API:
    Embedder(frame_reader, frame_embedder, frame_writer).start()).

    ``IN_FLIGHT`` calls of the marker's ``mark`` run at once, each on a
    thread of its own, and the writer gets their results in input order.
    Of the marker only ``mark`` and ``batch_size`` are asked, and ``mark``
    must take calls from several threads at once.  The first error of the
    reader, a call or the writer is raised once every thread has ended.
    ``stage_seconds``: ``read_wait`` and ``write_wait``, the loop's waits on
    its queues; ``compute``, the seconds inside the marker's calls, summed
    over calls that overlap."""

    def __init__(self, frame_reader, frame_marker: FrameMarker, frame_writer, prefetch: int = 2):
        self.reader = frame_reader
        self.marker = frame_marker
        self.writer = frame_writer
        self.prefetch = prefetch

    def start(self) -> PipelineStats:
        t0 = time.perf_counter()
        in_q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        out_q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        err: list = []

        def produce():
            try:
                while True:
                    batch = self.reader.read_batch(self.marker.batch_size)
                    if batch is None:
                        break
                    in_q.put(batch)
            except Exception as e:  # propagated below
                err.append(e)
            finally:
                in_q.put(_SENTINEL)

        def consume():
            try:
                while True:
                    batch = out_q.get()
                    if batch is _SENTINEL:
                        break
                    self.writer.write_batch(batch)
            except Exception as e:
                err.append(e)
                # keep draining until the sentinel so the main loop's bounded
                # put can never block forever and the error is raised
                while out_q.get() is not _SENTINEL:
                    pass

        clock = time.perf_counter_ns

        def call(batch):
            t = clock()
            marked = self.marker.mark(batch)
            return marked, clock() - t

        rt = threading.Thread(target=produce, daemon=True)
        wt = threading.Thread(target=consume, daemon=True)
        rt.start()
        wt.start()
        calls = ThreadPoolExecutor(IN_FLIGHT, thread_name_prefix="vfp-mark")
        pending: deque = deque()  # the calls in flight, oldest first

        n = 0
        wait_ns = compute_ns = write_ns = 0

        def deliver():
            nonlocal n, compute_ns, write_ns
            marked, ns = pending.popleft().result()
            t3 = clock()
            out_q.put(marked)
            t4 = clock()
            compute_ns += ns
            write_ns += t4 - t3
            profiling.record("embedder.write_wait", t3, t4)
            n += len(marked)

        try:
            while True:
                t1 = clock()
                batch = in_q.get()
                t2 = clock()
                wait_ns += t2 - t1
                profiling.record("embedder.read_wait", t1, t2)
                if batch is _SENTINEL:
                    break
                pending.append(calls.submit(call, batch))
                if len(pending) == IN_FLIGHT:
                    deliver()
            while pending:
                deliver()
        finally:
            # after an error: the calls not started are dropped, those running end
            calls.shutdown(wait=True, cancel_futures=True)
            out_q.put(_SENTINEL)
            # unblock a reader waiting on a full queue after a marker error
            while rt.is_alive():
                try:
                    in_q.get(timeout=0.1)
                except queue.Empty:
                    pass
            rt.join()
            wt.join()
            self.reader.close()
            self.writer.close()
        if err:
            raise err[0]
        wait_s, compute_s, write_s = wait_ns / 1e9, compute_ns / 1e9, write_ns / 1e9
        stats = PipelineStats(
            frames=n, seconds=time.perf_counter() - t0,
            stage_seconds={"read_wait": round(wait_s, 4), "compute": round(compute_s, 4),
                           "write_wait": round(write_s, 4)},
        )
        logger.info(
            "embedded %d frames in %.2fs (%.1f fps; read-wait %.2fs, compute %.2fs, "
            "write-wait %.2fs)", n, stats.seconds, stats.fps, wait_s, compute_s, write_s,
        )
        return stats
