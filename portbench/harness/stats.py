"""Arithmetic of the end-to-end metrics."""

from __future__ import annotations

import math


def rate(count: int, seconds: float) -> float:
    """Items per second over a window; the window must be positive."""
    if seconds <= 0:
        raise ValueError(f"a window of {seconds} s has no rate")
    return count / seconds


def percentile(values, q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between order
    statistics (NumPy's default method)."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)

