"""Leak tracing: recover the recipient fingerprint from a leaked copy
(port of ``vfp_tpu/fingerprint/trace.py``).

Each segment of the leak is decoded ONCE (batched on the device); the single
majority pattern is then compared against all candidate payloads (or
blind-decoded into 4+4 bits, reference: tests/detect_watermarks.py:145-172).
The leak may come in any container the port reads; it is re-segmented as
``segment_video`` segments it by default, as the JAX ``trace_leak`` does:
by ffmpeg into ``.mp4`` pieces where the binary is on PATH, else ``.rawv``
pieces of a ``.rawv`` leak and MJPEG ``.avi`` pieces of any other.
"""

from __future__ import annotations

import json
import logging
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from ..utils.device import resolve_device
from ..wm import DwtDctSvd
from .marker import segment_majorities
from .payloads import decode_segment_copy, pattern_string
from .segmenter import segment_video

logger = logging.getLogger(__name__)


@dataclass
class SegmentTrace:
    segment: str
    segment_number: int
    detected_copy_index: int | None
    match_frequency: float
    success: bool
    pattern: list = field(default_factory=list)


@dataclass
class TraceResult:
    segments: list
    fingerprint: str | None

    @property
    def success_rate(self) -> float:
        if not self.segments:
            return 0.0
        return sum(s.success for s in self.segments) / len(self.segments)

    @property
    def copy_sequence(self) -> list:
        return [s.detected_copy_index for s in sorted(self.segments, key=lambda s: s.segment_number)]

    def to_json(self) -> list:
        return [
            {
                "segment": Path(s.segment).name,
                "segment_number": s.segment_number,
                "detected_copy_index": s.detected_copy_index,
                "match_frequency": s.match_frequency,
                "success": s.success,
            }
            for s in self.segments
        ]


def trace_leak(
    leaked_file,
    output_dir,
    payload_file=None,
    segment_duration: float = 2.0,
    max_copies: int = 3,
    codec=None,
    key: int = 0,
    payload_len: int = 8,
    *,
    device="cuda",
) -> TraceResult:
    """Re-segment the leaked video on the marking grid and identify, per
    segment, which variant it came from, decoding on ``device``.  Writes
    detection_results.json (reference schema: tests/detect_watermarks.py:367-381)."""
    device = resolve_device(device)
    codec = codec or DwtDctSvd()
    output_dir = Path(output_dir)
    segments_dir = output_dir / "segments"
    output_dir.mkdir(parents=True, exist_ok=True)
    segments = segment_video(leaked_file, segments_dir, segment_duration)
    logger.info("re-segmented leak into %d segments", len(segments))

    payloads = json.loads(Path(payload_file).read_text()) if payload_file else {}

    traces = []
    majorities = segment_majorities(segments, payload_len, codec=codec, key=key, device=device)
    for seg_idx, (seg_file, (pattern, freq)) in enumerate(zip(segments, majorities)):
        detected = None
        if pattern is not None:
            if payloads:
                # one decode, compared against every candidate payload
                for copy_index in range(max_copies):
                    want = payloads.get(f"{seg_idx}_{copy_index}")
                    if want is not None and np.array_equal(pattern, np.asarray(want)):
                        detected = copy_index
                        break
            else:
                seg_no, copy_index = decode_segment_copy(pattern)
                if seg_no is not None and seg_no == seg_idx % 16:
                    detected = copy_index
        traces.append(
            SegmentTrace(
                segment=str(seg_file),
                segment_number=seg_idx,
                detected_copy_index=detected,
                match_frequency=freq if detected is not None else 0.0,
                success=detected is not None,
                pattern=pattern.tolist() if pattern is not None else [],
            )
        )
        logger.info(
            "segment %d: copy=%s freq=%.2f", seg_idx, detected, freq
        )

    result = TraceResult(
        segments=traces, fingerprint=pattern_string([t.detected_copy_index for t in traces])
    )
    (output_dir / "detection_results.json").write_text(json.dumps(result.to_json(), indent=2))
    return result
