"""The traced run: ``torch.profiler`` over the window, kept in memory and
reduced to a summary that the per-layer readers take.

The device timeline is the profiler's CUDA activity (kernels, memcpys,
memsets).  The host spans of the harness are placed on the same clock by
one annotation recorded at a known host time.  Nothing of the trace is
written to disk.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from dataclasses import dataclass, field

import torch

SYNC = "portbench.sync"


@dataclass
class Summary:
    """What the readers see.  Times in seconds, over the traced window."""

    kind: str  # "mark" or "detect": the suffix of the metrics this cell reports
    window_s: float
    busy_s: float  # union of all device activity
    htod_s: float
    dtoh_s: float
    noncopy_s: float  # kernels, memsets and device-to-device copies
    device_ops: dict  # name -> seconds
    idle: dict  # host span label -> (seconds, gaps, longest seconds)
    span_s: dict  # harness span name -> seconds
    counters: dict = field(default_factory=dict)  # batches, codec_bytes, ...
    extras: dict = field(default_factory=dict)  # values a driver measured itself


def _ns(ev, what: str) -> int:
    fn = getattr(ev, f"{what}_ns", None)
    return int(fn()) if fn is not None else int(getattr(ev, f"{what}_us")() * 1000)


class Tracer:
    def __init__(self):
        self.prof = None
        self._sync_host = 0  # perf_counter_ns just before the sync annotation

    def start(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self._sync_host = time.perf_counter_ns()
        with torch.profiler.record_function(SYNC):
            pass

    def stop(self) -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.stop()

    def events(self):
        """Device events [(name, t0, t1)] on the host's perf_counter_ns clock."""
        evs = self.prof.profiler.kineto_results.events()
        dev, sync = [], None
        for e in evs:
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                dev.append((e.name(), _ns(e, "start"), _ns(e, "start") + _ns(e, "duration")))
            elif sync is None and e.name() == SYNC:
                sync = _ns(e, "start")
        if sync is None:
            raise RuntimeError("the profiler recorded no sync annotation")
        off = sync - self._sync_host
        return [(n, a - off, b - off) for n, a, b in dev]


def summarize(kind: str, dev_events, spans, t0_ns: int, t1_ns: int, counters: dict,
              extras: dict | None = None) -> Summary:
    """Reduce device events [(name, t0, t1)] (host clock, ns) and the host
    spans to a Summary of the window [t0, t1]."""
    window = (t1_ns - t0_ns) / 1e9
    ops: dict = defaultdict(float)
    htod = dtoh = noncopy = 0.0
    ivals = []
    for name, a, b in dev_events:
        a, b = max(a, t0_ns), min(b, t1_ns)
        if b <= a:
            continue
        d = (b - a) / 1e9
        ops[name] += d
        if name.startswith("Memcpy HtoD"):
            htod += d
        elif name.startswith("Memcpy DtoH"):
            dtoh += d
        else:
            noncopy += d
        ivals.append((a, b))
    merged: list = []
    for a, b in sorted(ivals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    gaps, prev = [], t0_ns
    for a, b in merged:
        if a > prev:
            gaps.append((prev, a))
        prev = b
    if t1_ns > prev:
        gaps.append((prev, t1_ns))
    items = sorted(spans.items, key=lambda s: s[1])
    starts = [s[1] for s in items]
    idle: dict = {}
    for a, b in gaps:
        label = _label(items, starts, (a + b) // 2)
        s, n, longest = idle.get(label, (0.0, 0, 0.0))
        idle[label] = (s + (b - a) / 1e9, n + 1, max(longest, (b - a) / 1e9))
    span_s: dict = defaultdict(float)
    for name, a, b in items:
        if t0_ns <= a <= t1_ns:
            span_s[name] += (b - a) / 1e9
    return Summary(kind, window, busy / 1e9, htod, dtoh, noncopy, dict(ops), idle, dict(span_s),
                   dict(counters), dict(extras or {}))


def _label(items, starts, t: int, look_back: int = 256) -> str:
    """The harness span open at host time ``t`` that started last."""
    i = bisect.bisect_right(starts, t)
    for name, a, b in reversed(items[max(0, i - look_back):i]):
        if b >= t:
            return name
    return "outside harness spans"


def breakdown(s: Summary) -> dict:
    ops = sorted(s.device_ops.items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(s.idle.items(), key=lambda kv: -kv[1][0])[:10]
    return {
        "device_ops": [[n, v] for n, v in ops],
        "idle_gaps": [[f"{label} ({n} gaps, longest {longest * 1e3:.3f} ms)", sec]
                      for label, (sec, n, longest) in idle],
    }
