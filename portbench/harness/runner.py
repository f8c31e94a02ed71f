"""One run of one cell: set-up, the measured window, the check, the result.

Set-up is everything from process start to the first timed batch: imports,
the CUDA context, the inputs, the kernel library, the program's objects
and a warm-up over the same path and shapes as the window.  The window
runs for ``--seconds`` and drains what is in flight.  Then the memory peak
is read, the program's state is freed, and the plain reference judges the
answers.
"""

from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from . import stats, trace
from .drivers import DRIVERS, Ctx
from .spans import Spans
from .spec import metric_reader

FORBIDDEN = ("jax", "jaxlib", "flax", "vfp_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def host_copy_gbps(nbytes: int = 100 * 2**20) -> float:
    """The host's memcpy rate, beside a run's numbers: the staging copy, the
    largest host stage of every cell, runs at it."""
    a = np.ones(nbytes, np.uint8)
    b = np.empty_like(a)
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        np.copyto(b, a)
        times.append(time.perf_counter() - t0)
    return nbytes / sorted(times)[2] / 1e9


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _lap(split: dict, name: str, t: list) -> None:
    now = time.perf_counter_ns()
    split[name] = (now - t[0]) / 1e9
    t[0] = now


def execute(cell, seed: int, seconds: float, traced: bool, device, t_start_ns: int,
            split: dict | None = None, log=None) -> dict:
    """Run the cell once; returns the result object (``check`` last)."""
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    split = {} if split is None else split
    device = torch.device(device)
    spans = Spans(enabled=traced)
    ctx = Ctx(cell, seed, device, spans)
    driver = DRIVERS[cell.traffic["driver"]](ctx)
    t = [time.perf_counter_ns()]
    if device.type == "cuda":
        torch.cuda.init()
        torch.empty(1, device=device)
        _lap(split, "cuda_context_s", t)
        from vfp_tpu_torch.kernels import _build

        _build.library()
        _lap(split, "kernel_library_s", t)
    driver.prepare()
    _sync(device)
    _lap(split, "inputs_s", t)
    log(f"host copy: {host_copy_gbps():.2f} GB/s (100 MB, median of 5)")
    if device.type == "cuda":
        # the inputs are the harness's: the peak is the program's from here on
        torch.cuda.reset_peak_memory_stats(device)
    driver.build()
    driver.warm()
    _sync(device)
    _lap(split, "warm_up_s", t)
    tracer = None
    if traced:
        tracer = trace.Tracer()
        tracer.start()
        _lap(split, "profiler_start_s", t)
    win = driver.window(seconds)
    if tracer is not None:
        tracer.stop()
    _sync(device)
    split["setup_s"] = (win.t_first - t_start_ns) / 1e9
    log(f"setup split (s): {split}")

    kind = driver.kind
    values = {"setup_s": split["setup_s"],
              f"{kind}_frames_per_s": stats.rate(win.delivered, win.seconds)}
    if win.latencies_ms:
        values["segment_p95_ms"] = stats.percentile(win.latencies_ms, 95)
    log(f"window: {win.seconds:.3f} s, {win.batches} batches, {win.delivered} delivered of "
        f"{win.attempted}" + (f", {len(win.latencies_ms)} segments, p95 "
                              f"{values['segment_p95_ms']:.3f} ms" if win.latencies_ms else "")
        + f"; units/s by quarter {[round(q, 1) for q in win.quarters()]}")

    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1,
           "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                                 if device.type == "cuda" else 0)}
    metrics, out = {}, {}
    if traced:
        summary = trace.summarize(kind, tracer.events() if device.type == "cuda" else [], spans,
                                  win.t_first, win.t_last,
                                  {"batches": win.batches, "codec_bytes": win.codec_bytes},
                                  {k: v for k, v in values.items() if k != "setup_s"})
        dev["busy_s"] = summary.busy_s
        dev["window_s"] = summary.window_s
        for m in cell.per_layer:
            v = metric_reader(m["name"])(summary)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        out["breakdown"] = trace.breakdown(summary)
        tracer = None
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}

    driver.release()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    with torch.no_grad():
        numbers = driver.check()
    numbers["undelivered"] = win.attempted - win.delivered
    log(f"check took {time.perf_counter() - t_check:.3f} s")
    limits = cell.config["check"][kind]
    missing = set(limits) - set(numbers)
    if missing:
        raise KeyError(f"limits without a number: {sorted(missing)}")
    correct = all(numbers[k] <= limits[k] for k in limits)
    failed = numbers["undelivered"] + numbers.get("payload_errors", 0)
    return {"correct": correct, "attempted": win.attempted, "failed": failed,
            "metrics": metrics, "device": dev, **out,
            "check": {k: {"value": numbers[k], "limit": limits[k]} for k in limits}}
