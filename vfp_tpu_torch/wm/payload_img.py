"""Keyed spread-spectrum and block-scrambled image payloads of the DT-CWT
codecs (port of ``vfp_tpu/wm/payload_img.py``): ``CorrShuffler`` makes a
keyed +-1 plane resized to the codec's capacity, ``DeCorrShuffler`` detects
it by normalised correlation; ``BlockShuffler`` scrambles an image payload's
blocks with a keyed permutation for ``DtcwtImg``, ``DeBlockShuffler``
unscrambles a recovered plane back to the payload's shape.

Generation and unscrambling are host-side NumPy: the keyed ``RandomState``
permutations as in the JAX package, and the port's own copies of cv2's
float32 INTER_LINEAR and INTER_AREA resizes (``ops/filters.py``).  The
correlation runs batched on the planes' device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.filters import resize_area, resize_linear
from ..utils import profiling


def _keyed_pm1_plane(key, shape=(1080, 1920)) -> np.ndarray:
    wm = np.random.RandomState(key).randint(0, 2, shape).astype(np.float32)
    wm[wm == 0] = -1
    return wm


class CorrShuffler:
    """Presence-only keyed +-1 plane resized to capacity; the payload is ignored."""

    wm_kind = "bits"

    def __init__(self, key=None):
        self.key = key

    @staticmethod
    def wm_type() -> str:
        return "bits"

    def generate_wm(self, payload, capacity, shape=(1080, 1920)) -> np.ndarray:
        return resize_linear(_keyed_pm1_plane(self.key, shape), capacity)


class DeCorrShuffler:
    """Normalised-correlation presence detector; present when corr > threshold."""

    def __init__(self, key=None, threshold: float = 0.1):
        self.key = key
        self.threshold = threshold
        self._ref_cache = {}

    def set_shape(self, payload_shape):
        return self

    def _reference(self, shape) -> np.ndarray:
        if shape not in self._ref_cache:
            self._ref_cache[shape] = resize_linear(_keyed_pm1_plane(self.key), shape)
        return self._ref_cache[shape]

    def correlation_batch(self, wm: torch.Tensor) -> torch.Tensor:
        """[B, h, w] recovered planes -> [B] normalised correlations, with the
        population standard deviation (``correction=0``), as jnp.std."""
        with profiling.sync_span("sync.corr_reference", wm):
            ref = torch.as_tensor(self._reference((wm.shape[-2], wm.shape[-1])), device=wm.device)
        n = wm.shape[-2] * wm.shape[-1]
        dims = (-2, -1)
        wmn = ((wm - wm.mean(dim=dims, keepdim=True))
               / wm.std(dim=dims, keepdim=True, correction=0))
        refn = (ref - ref.mean()) / ref.std(correction=0)
        return (wmn * refn).sum(dim=dims) / n

    def degenerate_batch(self, wm: torch.Tensor) -> torch.Tensor:
        """[B, h, w] -> [B, 1] uint8 presence flags."""
        return (self.correlation_batch(wm) > self.threshold).to(torch.uint8)[:, None]

    def correlation(self, wm, mode: str = "fast") -> float:
        """The detection statistic of one recovered plane [h, w]: ``fast``, its
        normalised correlation (``correlation_batch``); ``slow``, the maximum
        of the full 2-D cross-correlation with the reference plane over h * w
        (scipy's ``correlate2d``), the reference's exhaustive search."""
        if mode == "slow":
            from scipy.signal import correlate2d

            plane = np.asarray(wm.cpu() if torch.is_tensor(wm) else wm)
            c = correlate2d(plane, self._reference(plane.shape))
            return float((c / (plane.shape[0] * plane.shape[1])).max())
        return float(self.correlation_batch(torch.as_tensor(np.asarray(wm, np.float32))[None])[0])

    def degenerate(self, wm, mode: str = "fast") -> bool:
        """Presence of the keyed plane: ``correlation(wm, mode) > threshold``."""
        return self.correlation(wm, mode) > self.threshold


def _blocks(channel: np.ndarray, blk_shape):
    """The whole [bh, bw] blocks of ``channel`` as [rows/bh * cols/bw, bh, bw]
    in row-major block order, and the covered extent (rows, cols)."""
    bh, bw = blk_shape
    rows = channel.shape[0] // bh * bh
    cols = channel.shape[1] // bw * bw
    flat = (channel[:rows, :cols].reshape(rows // bh, bh, cols // bw, bw)
            .transpose(0, 2, 1, 3).reshape(-1, bh, bw))
    return flat, rows, cols


def _unblocks(channel: np.ndarray, flat: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """``channel`` with its covered extent replaced by the blocks ``flat``."""
    bh, bw = flat.shape[1:]
    out = np.copy(channel)
    out[:rows, :cols] = (flat.reshape(rows // bh, cols // bw, bh, bw)
                         .transpose(0, 2, 1, 3).reshape(rows, cols))
    return out


class BlockShuffler:
    """Keyed block-scrambled image payload: the image resized to ``shape``,
    its whole ``blk_shape`` blocks permuted by the key, resized to the
    codec's capacity and binarised to +-255 at 127."""

    wm_kind = "grayscale"

    def __init__(self, key=None, blk_shape=(35, 30)):
        self.key = key
        self.blk_shape = blk_shape

    @staticmethod
    def wm_type() -> str:
        return "grayscale"

    def randomize_channel(self, channel: np.ndarray, key, blk_shape=(8, 8)) -> np.ndarray:
        flat, rows, cols = _blocks(channel, blk_shape)
        np.random.RandomState(key).shuffle(flat)
        return _unblocks(channel, flat, rows, cols)

    def generate_wm(self, payload: np.ndarray, capacity, shape=(135, 240)) -> np.ndarray:
        wm = resize_linear(np.asarray(payload, np.float32), shape)
        wm = self.randomize_channel(wm, self.key, self.blk_shape)
        wm = resize_linear(wm, capacity)
        return np.where(wm > 127, 255, -255).astype(np.int32)


class DeBlockShuffler:
    """Inverse of :class:`BlockShuffler`: a recovered plane resized to
    ``shape``, its blocks put back by the inverse permutation, resized to
    the payload's shape."""

    def __init__(self, key=None, blk_shape=(35, 30)):
        self.key = key
        self.blk_shape = blk_shape

    def set_shape(self, payload_shape):
        self.payload_shape = tuple(payload_shape)
        return self

    def derandomize_channel(self, channel: np.ndarray, key, blk_shape=(8, 8)) -> np.ndarray:
        flat, rows, cols = _blocks(channel, blk_shape)
        idx = np.arange(flat.shape[0])
        np.random.RandomState(key).shuffle(idx)
        res = np.zeros_like(flat)
        res[idx] = flat
        return _unblocks(channel, res, rows, cols)

    def degenerate(self, wm, shape=(135, 240), antialias: bool = False) -> np.ndarray:
        """Descramble a recovered plane back to the payload shape.
        ``antialias=False`` resizes the descrambled plane with INTER_LINEAR,
        as the reference; ``antialias=True`` with INTER_AREA, the block
        average, which reads the image where INTER_LINEAR point-samples the
        decoder's fine-scale ringing."""
        x = resize_linear(np.asarray(wm, np.float32), shape)
        x = self.derandomize_channel(x, self.key, self.blk_shape)
        resize = resize_area if antialias else resize_linear
        return resize(x, self.payload_shape)
