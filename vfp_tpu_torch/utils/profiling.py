"""Profiling hooks (port of ``vfp_tpu/utils/profiling.py``): a
``torch.profiler`` trace of a block, written as a Chrome trace, and
per-stage wall-second counters."""

from __future__ import annotations

import contextlib
import logging
import os
import time
from collections import defaultdict
from pathlib import Path

import torch

logger = logging.getLogger(__name__)


@contextlib.contextmanager
def profile_trace(log_dir, device=None):
    """Capture a ``torch.profiler`` trace around a block and write it into
    ``log_dir`` as ``trace_<pid>_<time>.json`` (chrome://tracing, Perfetto).
    The CPU is always traced, the GPU too when ``device`` is a CUDA device
    (``None``: when torch sees one)."""
    cuda = (torch.cuda.is_available() if device is None
            else torch.device(device).type == "cuda")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    path = out / f"trace_{os.getpid()}_{time.time_ns()}.json"
    prof.export_chrome_trace(str(path))
    logger.info("profiler trace written to %s", path)


class StageTimer:
    """Accumulates wall seconds and item counts per named stage."""

    def __init__(self):
        self.seconds = defaultdict(float)
        self.items = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, items: int = 0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] += time.perf_counter() - t0
            self.items[name] += items

    def report(self) -> dict:
        return {
            name: {
                "seconds": round(self.seconds[name], 4),
                "items": self.items[name],
                "items_per_sec": round(self.items[name] / self.seconds[name], 2)
                if self.seconds[name]
                else 0.0,
            }
            for name in self.seconds
        }
