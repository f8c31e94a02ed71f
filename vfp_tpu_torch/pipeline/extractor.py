"""Extraction pipeline: reader -> batched device decode -> payload vote
(port of ``vfp_tpu/pipeline/extractor.py``).

Decoding and despreading run per batch on the device; only the per-frame
payloads come back to the host, where the majority vote is taken once.  With
``VFP_LOWLINK=1`` (or ``VFP_LL_WIRE=host``) the flagship codec's extractor
sends the LL band up instead of frames (``lowlink.LowLinkExtractor``).

Spans (``utils/profiling.py``): ``extractor.extract`` around the batch call
(items = frames, a new batch id) and ``codec.extract`` around the codec's
enqueue of the decode and the despread.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from collections import Counter
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from ..utils import profiling
from .embedder import use_lowlink
from .lowlink import LowLinkExtractor, default_wire
from .transfer import Pending, download, upload_batch

logger = logging.getLogger(__name__)

_SENTINEL = None


class FrameExtractor:
    """Binds a codec + degenerator into a uint8 batch -> payload map on ``device``."""

    def __init__(self, codec, degenerator, batch_size: int = 16, *, device):
        self.codec = codec
        self.degenerator = degenerator
        self.batch_size = batch_size
        self.device = torch.device(device)
        self._ll = (LowLinkExtractor(codec, degenerator, batch_size, device=self.device)
                    if use_lowlink(codec) else None)

    def extract(self, frames: np.ndarray) -> np.ndarray:
        """[k, H, W, 3] u8 -> [k, payload_len] u8 payloads."""
        with profiling.span("extractor.extract", len(frames), batch=profiling.NEW_BATCH):
            return self.collect(self.submit(frames))

    @torch.inference_mode()
    def submit(self, frames: np.ndarray):
        """Enqueue the upload, the decode and the download of the payloads
        alone, and return without waiting on the device (on the CPU: decode
        now)."""
        if self._ll is not None:
            return self._ll.submit(frames)
        x = upload_batch(frames, self.batch_size, self.device)
        with profiling.span("codec.extract", len(x)):
            payloads = self.degenerator.degenerate_batch(self.codec.extract_frames(x))
        return download([payloads], len(frames))

    def collect(self, handle) -> np.ndarray:
        """[k, payload_len] u8 payloads of a ``submit``, once its event has passed."""
        if self._ll is not None:
            return self._ll.collect(handle)
        return handle.wait()[0]


def cached_bit_extractor(codec, key, payload_len: int, batch_size: int = 16,
                         threshold: str = "fixed", *, device) -> FrameExtractor:
    """Memoized FrameExtractor for bit payloads, keyed by every argument
    (the codec is a frozen dataclass, so it hashes by value) and by the
    transport's resolved wire: an extractor binds its wire when it is made,
    so a change of ``VFP_LOWLINK`` or ``VFP_LL_WIRE`` in the process must
    not reuse one made under the old setting."""
    wire = default_wire() if use_lowlink(codec) else None
    return _cached_bit_extractor(codec, key, payload_len, batch_size, threshold,
                                 str(torch.device(device)), wire)


@lru_cache(maxsize=64)
def _cached_bit_extractor(codec, key, payload_len: int, batch_size: int, threshold: str,
                          device: str, wire) -> FrameExtractor:
    from ..wm import DeShuffler

    deg = DeShuffler(key=key, threshold=threshold).set_shape((payload_len,))
    return FrameExtractor(codec, deg, batch_size=batch_size, device=device)


@dataclass
class ExtractResult:
    payloads: np.ndarray  # [N, payload_len] uint8, one per frame
    seconds: float

    @property
    def frames(self) -> int:
        return len(self.payloads)

    @property
    def fps(self) -> float:
        return self.frames / self.seconds if self.seconds else 0.0

    def majority(self):
        """(most_common_payload, frequency) over frames — the reference's Counter vote."""
        if not len(self.payloads):
            return None, 0.0
        counter = Counter(map(tuple, self.payloads.tolist()))
        pattern, count = counter.most_common(1)[0]
        return np.array(pattern, dtype=np.uint8), count / len(self.payloads)


class Extractor:
    """Drive reader -> extractor over a whole stream (reference API:
    Extractor(frame_reader, frame_extractor, degenerator).start())."""

    def __init__(self, frame_reader, frame_extractor: FrameExtractor, prefetch: int = 2):
        self.reader = frame_reader
        self.extractor = frame_extractor
        self.prefetch = prefetch

    def start(self) -> ExtractResult:
        t0 = time.perf_counter()
        in_q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        err: list = []

        def produce():
            try:
                while True:
                    batch = self.reader.read_batch(self.extractor.batch_size)
                    if batch is None:
                        break
                    in_q.put(batch)
            except Exception as e:  # propagated below
                err.append(e)
            finally:
                in_q.put(_SENTINEL)

        rt = threading.Thread(target=produce, daemon=True)
        rt.start()
        outs = []
        try:
            while True:
                batch = in_q.get()
                if batch is _SENTINEL:
                    break
                outs.append(self.extractor.extract(batch))
        finally:
            # unblock a reader waiting on a full queue after an extractor error
            while rt.is_alive():
                try:
                    in_q.get(timeout=0.1)
                except queue.Empty:
                    pass
            rt.join()
            self.reader.close()
        if err:
            raise err[0]
        payloads = np.concatenate(outs) if outs else np.zeros((0, 0), np.uint8)
        res = ExtractResult(payloads=payloads, seconds=time.perf_counter() - t0)
        logger.info("extracted %d frames in %.2fs (%.1f fps)", res.frames, res.seconds, res.fps)
        return res
