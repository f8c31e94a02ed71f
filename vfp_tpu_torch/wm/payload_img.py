"""Keyed spread-spectrum plane for the DT-CWT key codec (port of the first half
of ``vfp_tpu/wm/payload_img.py``): ``CorrShuffler`` makes a keyed +-1 plane
resized to the codec's capacity, ``DeCorrShuffler`` detects it by
normalised correlation.

Generation is host-side NumPy: the keyed ``RandomState`` plane as in the JAX
package, and the port's own copy of cv2's float32 INTER_LINEAR resize
(``ops/filters.py:resize_linear``), computed once per shape.  The correlation
runs batched on the planes' device.  ``BlockShuffler`` comes with the image
codec (ROADMAP.md queue 1).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.filters import resize_linear


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

    def degenerate(self, wm) -> bool:
        return bool(self.correlation_batch(torch.as_tensor(np.asarray(wm, np.float32))[None])[0]
                    > self.threshold)
