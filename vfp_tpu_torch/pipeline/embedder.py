"""Embedding pipeline: reader -> batched device mark -> writer, stages overlapped
(port of ``vfp_tpu/pipeline/embedder.py``).

Frames move in ``[B, H, W, 3]`` batches; a reader thread decodes batch k+1
and a writer thread encodes batch k-1 while the device marks batch k.  The
JAX package's low-link transport is not ported: it exists for a TPU behind a
slow relay.  Every class takes the device it runs on.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

logger = logging.getLogger(__name__)

_SENTINEL = None


def upload_batch(frames: np.ndarray, batch_size: int, device: torch.device) -> torch.Tensor:
    """[k, H, W, 3] u8 -> [batch_size, H, W, 3] on ``device``, padded with
    copies of the last frame so every batch has one shape.  On a CUDA device
    the frames go through pinned host memory."""
    k = len(frames)
    host = torch.empty((max(batch_size, k), *frames.shape[1:]), dtype=torch.uint8,
                       pin_memory=device.type == "cuda")
    h = host.numpy()
    h[:k] = frames
    h[k:] = frames[-1:]
    return host.to(device, non_blocking=True)


class FrameMarker:
    """Binds a codec + spread watermark into a uint8 batch transform on ``device``."""

    def __init__(self, codec, wm: np.ndarray, batch_size: int = 16, *, device):
        self.codec = codec
        self.device = torch.device(device)
        self.wm = torch.as_tensor(np.asarray(wm, np.float32).reshape(-1), device=self.device)
        self.batch_size = batch_size

    @torch.inference_mode()
    def mark(self, frames: np.ndarray) -> np.ndarray:
        k = len(frames)
        x = upload_batch(frames, self.batch_size, self.device)
        return self.codec.mark_frames(x, self.wm)[:k].cpu().numpy()


class MultiMarker:
    """Marks every watermark variant of each frame batch (the HLS copies);
    the frames are uploaded once per batch."""

    def __init__(self, codec, wms, batch_size: int = 16, *, device):
        self.codec = codec
        self.device = torch.device(device)
        self.wms = torch.as_tensor(
            np.stack([np.asarray(w, np.float32).reshape(-1) for w in wms]), device=self.device)
        self.batch_size = batch_size

    @property
    def n_variants(self) -> int:
        return len(self.wms)

    @torch.inference_mode()
    def mark_all(self, frames: np.ndarray) -> np.ndarray:
        """[k, H, W, 3] -> [V, k, H, W, 3] uint8."""
        k = len(frames)
        x = upload_batch(frames, self.batch_size, self.device)
        out = torch.stack([self.codec.mark_frames(x, w) for w in self.wms])
        return out[:, :k].cpu().numpy()


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
    Embedder(frame_reader, frame_embedder, frame_writer).start())."""

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

        rt = threading.Thread(target=produce, daemon=True)
        wt = threading.Thread(target=consume, daemon=True)
        rt.start()
        wt.start()

        n = 0
        wait_s = compute_s = 0.0
        try:
            while True:
                t1 = time.perf_counter()
                batch = in_q.get()
                wait_s += time.perf_counter() - t1
                if batch is _SENTINEL:
                    break
                t1 = time.perf_counter()
                out_q.put(self.marker.mark(batch))
                compute_s += time.perf_counter() - t1
                n += len(batch)
        finally:
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
        stats = PipelineStats(
            frames=n, seconds=time.perf_counter() - t0,
            stage_seconds={"read_wait": round(wait_s, 4), "compute": round(compute_s, 4)},
        )
        logger.info(
            "embedded %d frames in %.2fs (%.1f fps; read-wait %.2fs, compute %.2fs)",
            n, stats.seconds, stats.fps, wait_s, compute_s,
        )
        return stats
