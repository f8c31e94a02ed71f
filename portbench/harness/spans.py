"""Host spans recorded by the harness around its calls into the program.

A span is (name, start, end) on ``time.perf_counter_ns``; any thread may
record.  Kept in memory; the profiler summary reads them once the window
has closed.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager


class Spans:
    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.items: list = []  # (name, t0_ns, t1_ns)
        self._lock = threading.Lock()

    @contextmanager
    def span(self, name: str):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            t1 = time.perf_counter_ns()
            with self._lock:
                self.items.append((name, t0, t1))

