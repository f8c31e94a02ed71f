"""Peaks of the chip and the least bytes each codec call moves.

Peak: NVIDIA's H100 SXM data sheet, HBM3 at 3.35 TB/s at the full 700 W
limit.  The codecs' calls are bound by memory (a few hundred register
FLOPs per 64 bytes of 4x4 block against 67 TFLOP/s of float32), so the
bytes set their least time.

Least bytes of a call, from its shapes: a mark of ``variants`` watermarks
reads the uint8 batch once and writes each marked copy once; an extract
reads the batch once and writes its payloads.  Frames counted are the
caller's, not the padding the program adds to fill a batch.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12


def frame_bytes(h: int, w: int) -> int:
    return h * w * 3


def mark_bytes(frames: int, h: int, w: int, variants: int = 1) -> int:
    return frames * frame_bytes(h, w) * (1 + variants)


def extract_bytes(frames: int, h: int, w: int, payload_len: int) -> int:
    return frames * (frame_bytes(h, w) + payload_len)


def least_seconds(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S
