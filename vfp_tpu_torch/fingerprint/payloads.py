"""Segment/copy payload codec: 4-bit segment# + 4-bit copy# per frame
(copied from ``vfp_tpu/fingerprint/payloads.py``).

(reference: tests/mark_video_to_hls.py:27-43, tests/detect_watermarks.py:145-172)
"""

from __future__ import annotations

import numpy as np


def payload_for_segment(segment_number: int, copy_index: int = 0) -> np.ndarray:
    """8-bit payload: top 4 bits = segment# mod 16, bottom 4 = copy# mod 16."""
    bits = format(segment_number % 16, "04b") + format(copy_index % 16, "04b")
    return np.array([int(b) for b in bits])


def decode_segment_copy(pattern) -> tuple:
    """Inverse of :func:`payload_for_segment`; (segment_number, copy_index)."""
    if pattern is None:
        return None, None
    s = "".join(str(int(b)) for b in np.asarray(pattern).flatten())
    if len(s) < 8:
        return None, None
    return int(s[:4], 2), int(s[4:8], 2)


def pattern_string(copy_sequence) -> str | None:
    """Compact recipient fingerprint, e.g. [0,1,2] -> '012'; None if gaps."""
    if any(c is None for c in copy_sequence):
        return None
    return "".join(str(int(c)) for c in copy_sequence)
