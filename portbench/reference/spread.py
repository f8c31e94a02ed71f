"""Payload spreading and recovery, as offmark-py's Shuffler, DeShuffler and
the keyed +-1 plane of its DT-CWT key encoder describe them.

Spreading: the payload bits shuffled by ``np.random.RandomState(key)``,
then tiled to the codec's capacity.  Recovery: the mean of every payload
position's tiled repeats, the keyed permutation undone, a threshold at 0.5.
The key plane: ``RandomState(key).randint(0, 2, (1080, 1920))`` as +-1,
resized to the codec's capacity by cv2's float INTER_LINEAR.
"""

import math

import numpy as np


def segment_payload(segment: int, copy: int) -> np.ndarray:
    """The HLS workflow's 8-bit payload: segment number mod 16 in the top
    four bits, copy number mod 16 in the bottom four."""
    s = format(segment % 16, "04b") + format(copy % 16, "04b")
    return np.array([int(c) for c in s], np.int64)


def bits_of(text: str) -> np.ndarray:
    return np.array([int(c) for c in text], np.int64)


def spread_bits(payload: np.ndarray, key: int, total: int) -> np.ndarray:
    """[total] float32 0/1 plane carrying ``payload``."""
    p = np.array(payload).flatten().copy()
    np.random.RandomState(key).shuffle(p)
    reps = int(math.ceil(total / p.size))
    return np.tile(p, reps)[:total].astype(np.float32)


def despread_bits(planes: np.ndarray, key: int, payload_len: int) -> np.ndarray:
    """[..., total] decoded 0/1 planes -> [..., payload_len] uint8 payloads."""
    planes = np.asarray(planes, np.float64)
    total = planes.shape[-1]
    sums = np.zeros((*planes.shape[:-1], payload_len))
    counts = np.zeros(payload_len)
    for i in range(payload_len):
        sums[..., i] = planes[..., i::payload_len].sum(axis=-1)
        counts[i] = len(range(i, total, payload_len))
    means = sums / counts
    perm = np.arange(payload_len)
    np.random.RandomState(key).shuffle(perm)
    out = np.zeros_like(means)
    out[..., perm] = means
    return (out > 0.5).astype(np.uint8)


def _linear_taps(dst: int, src: int):
    """cv2 INTER_LINEAR taps of one axis (its IPP branch for float images):
    source (d + 0.5) * src / dst - 0.5 in double, both taps clipped."""
    f = (np.arange(dst) + 0.5) * (src / dst) - 0.5
    s = np.floor(f)
    si = s.astype(np.int64)
    return np.clip(si, 0, src - 1), np.clip(si + 1, 0, src - 1), (f - s).astype(np.float32)


def _lerp(a0, a1, t):
    # fma(a1 - a0, t, a0) in float32: one rounding of the sum
    return (a0.astype(np.float64) + (a1 - a0).astype(np.float64) * t).astype(np.float32)


def resize_linear(img: np.ndarray, size) -> np.ndarray:
    """cv2.resize(img, (w, h)) of a 2-D float32 image, INTER_LINEAR: the
    horizontal pass, then the vertical one."""
    h, w = size
    img = np.asarray(img, np.float32)
    x0, x1, tx = _linear_taps(w, img.shape[1])
    y0, y1, ty = _linear_taps(h, img.shape[0])
    rows = _lerp(img[:, x0], img[:, x1], tx)
    return _lerp(rows[y0], rows[y1], ty[:, None])


def key_plane(key: int, size, shape=(1080, 1920)) -> np.ndarray:
    """The DT-CWT key encoder's watermark: a keyed +-1 plane resized to
    ``size``."""
    wm = np.random.RandomState(key).randint(0, 2, shape).astype(np.float32)
    wm[wm == 0] = -1
    return resize_linear(wm, size)
