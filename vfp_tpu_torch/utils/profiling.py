"""Profiling hooks (port of ``vfp_tpu/utils/profiling.py``): a
``torch.profiler`` trace of a block, written as a Chrome trace, per-stage
wall-second counters, and the program's span recorder.

The span recorder times the batch path from inside: each layer boundary
(the batch call, the staging copy and, where it is split across host
threads, its fan-out, the copies' enqueues, the codec's enqueue, every
host wait on the device) opens a ``span``.  It is off unless
``record_spans()`` is open; while off, a span costs one flag test and
returns a shared no-op.  While it records, each span reads
``time.perf_counter_ns`` at its ends (the clock a device trace is mapped
to), notes the span open on its thread when it started (its parent) and
the batch it belongs to, and, under an active ``torch.profiler``, also
opens a ``record_function`` range of its name, so a Chrome trace shows
the spans beside the kernels.  A batch id is drawn where a batch call
takes a batch (``batch=NEW_BATCH``); the spans under it inherit it, and a
handle that another thread collects carries it there.  There is one
recorder per process, as there is one staging pool: the spans sit deep in
the transfers and the codecs, which no caller threads an object through.
"""

from __future__ import annotations

import contextlib
import itertools
import logging
import os
import threading
import time
from collections import defaultdict
from pathlib import Path
from typing import NamedTuple

import torch

logger = logging.getLogger(__name__)


@contextlib.contextmanager
def profile_trace(log_dir, device=None):
    """Capture a ``torch.profiler`` trace around a block and write it into
    ``log_dir`` as ``trace_<pid>_<time>.json`` (chrome://tracing, Perfetto).
    The CPU is always traced, on every thread (``Embedder`` marks on threads
    of its own), the GPU too when ``device`` is a CUDA device (``None``:
    when torch sees one)."""
    global _trace_all_threads
    cuda = (torch.cuda.is_available() if device is None
            else torch.device(device).type == "cuda")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    config = torch.profiler._ExperimentalConfig(profile_all_threads=True)
    with torch.profiler.profile(activities=activities, experimental_config=config) as prof:
        _trace_all_threads = True
        try:
            yield prof
        finally:
            _trace_all_threads = False
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


class Span(NamedTuple):
    """One recorded span: ``t0``/``t1`` in ``time.perf_counter_ns``."""

    id: int
    name: str
    t0: int
    t1: int
    parent: int | None  # the span open on the same thread when this one started
    batch: int | None  # the batch call's id; None outside a batch
    items: int  # frames or bytes, given where the span opens
    thread: int  # threading.get_ident() of the thread that recorded it


NEW_BATCH = object()  # ``span(..., batch=NEW_BATCH)``: this span takes a new batch


class _Off:
    """The shared no-op of a span while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


OFF = _Off()
_on = False
# ``profile_trace``'s profiler is on, recording every thread; a thread other
# than the one that started it sees ``_profiler_enabled()`` False
_trace_all_threads = False
_spans: list = []
_ids = itertools.count(1)
_batches = itertools.count(1)
_local = threading.local()
_lock = threading.Lock()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Open:
    __slots__ = ("name", "items", "batch", "id", "parent", "t0", "rf")

    def __init__(self, name: str, items: int, batch):
        self.name, self.items, self.batch = name, items, batch

    def __enter__(self):
        stack = _stack()
        up = stack[-1] if stack else None
        self.parent = up.id if up is not None else None
        if self.batch is NEW_BATCH:
            self.batch = next(_batches)
        elif self.batch is None and up is not None:
            self.batch = up.batch
        self.id = next(_ids)
        stack.append(self)
        self.rf = None
        if _trace_all_threads or torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return None

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
        _stack().pop()
        _spans.append(Span(self.id, self.name, self.t0, t1, self.parent, self.batch,
                             self.items, threading.get_ident()))
        return False


def span(name: str, items: int = 0, batch=None):
    """A context manager timing its block as span ``name`` while
    ``record_spans`` is open, else the shared no-op.  ``batch``: None to
    inherit the open span's batch, ``NEW_BATCH`` to take a new one, or the
    id a handle carries."""
    if not _on:
        return OFF
    return _Open(name, items, batch)


def sync_span(name: str, tensor: torch.Tensor):
    """``span(name)`` around a copy between the host and ``tensor``'s device,
    which blocks the host only where that device is a card: elsewhere, and
    while nothing records, the shared no-op."""
    if not _on or not tensor.is_cuda:
        return OFF
    return _Open(name, 0, None)


def record(name: str, t0: int, t1: int) -> None:
    """Record a span whose ends the caller read from ``time.perf_counter_ns``
    (a loop that keeps its own totals of the same clock reads); a no-op
    while nothing records."""
    if not _on:
        return
    stack = _stack()
    up = stack[-1] if stack else None
    _spans.append(Span(next(_ids), name, t0, t1, up.id if up is not None else None,
                       up.batch if up is not None else None, 0, threading.get_ident()))


def current_batch() -> int | None:
    """The batch of the span open on this thread (None while nothing records)."""
    if not _on:
        return None
    stack = _stack()
    return stack[-1].batch if stack else None


@contextlib.contextmanager
def record_spans():
    """Turn the span recorder on for the block; the list it yields holds
    every span that ended inside it once the block has closed."""
    global _on, _spans
    with _lock:
        if _on:
            raise RuntimeError("the span recorder is already recording")
        _spans, _on = [], True
    out: list = []
    try:
        yield out
    finally:
        with _lock:
            _on = False
            out.extend(_spans)
            _spans = []


def span_table(spans) -> dict:
    """name -> (count, total ns, self ns): a span's self time is its
    duration less the part that its child spans cover."""
    child_ns: dict = defaultdict(int)
    for s in spans:
        if s.parent is not None:
            child_ns[s.parent] += s.t1 - s.t0
    table: dict = {}
    for s in spans:
        n, total, own = table.get(s.name, (0, 0, 0))
        d = s.t1 - s.t0
        table[s.name] = (n + 1, total + d, own + d - child_ns[s.id])
    return table


def span_lines(spans) -> list:
    """One line per span name, longest total first: count, total ms, self ms."""
    rows = sorted(span_table(spans).items(), key=lambda kv: -kv[1][1])
    return [f"span {name}: count {n}, total {total / 1e6:.3f} ms, self {own / 1e6:.3f} ms"
            for name, (n, total, own) in rows]
