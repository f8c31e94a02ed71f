"""Extraction pipeline: reader -> batched device decode -> payload vote
(port of ``vfp_tpu/pipeline/extractor.py``).

Decoding and despreading run per batch on the device; only the per-frame
payloads come back to the host, where the majority vote is taken once.
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

from .embedder import upload_batch

logger = logging.getLogger(__name__)

_SENTINEL = None


class FrameExtractor:
    """Binds a codec + degenerator into a uint8 batch -> payload map on ``device``."""

    def __init__(self, codec, degenerator, batch_size: int = 16, *, device):
        self.codec = codec
        self.degenerator = degenerator
        self.batch_size = batch_size
        self.device = torch.device(device)

    @torch.inference_mode()
    def extract(self, frames: np.ndarray) -> np.ndarray:
        """[k, H, W, 3] u8 -> [k, payload_len] u8 payloads."""
        k = len(frames)
        x = upload_batch(frames, self.batch_size, self.device)
        bits = self.codec.extract_frames(x)
        return self.degenerator.degenerate_batch(bits)[:k].cpu().numpy()


def cached_bit_extractor(codec, key, payload_len: int, batch_size: int = 16,
                         threshold: str = "fixed", *, device) -> FrameExtractor:
    """Memoized FrameExtractor for bit payloads, keyed by every argument
    (the codec is a frozen dataclass, so it hashes by value)."""
    return _cached_bit_extractor(codec, key, payload_len, batch_size, threshold,
                                 str(torch.device(device)))


@lru_cache(maxsize=64)
def _cached_bit_extractor(codec, key, payload_len: int, batch_size: int, threshold: str,
                          device: str) -> FrameExtractor:
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
