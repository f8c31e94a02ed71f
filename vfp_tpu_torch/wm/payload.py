"""Keyed payload spreading and recovery (port of ``vfp_tpu/wm/payload.py``).

Spreading runs once per payload on the host in NumPy, with the same keyed
``np.random.RandomState`` permutations as the JAX package and the reference,
so a plane spread by either package is recovered by the other.  Recovery runs
per frame batch on the tensors' device.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=None)
def keyed_shuffle_indices(key, n: int) -> np.ndarray:
    """The permutation np.random.RandomState(key).shuffle applies to arange(n)."""
    idx = np.arange(n)
    np.random.RandomState(key).shuffle(idx)
    return idx


def _tile_to(payload_flat: np.ndarray, total: int) -> np.ndarray:
    reps = int(math.ceil(total / payload_flat.size))
    return np.tile(payload_flat, reps)[:total]


def despread_mean(wm_flat: torch.Tensor, payload_len: int, total_len: int) -> torch.Tensor:
    """Per-position mean over the tiled repeats: out[i] = mean(wm[i::P]).

    ``wm_flat`` is [..., total_len]; returns [..., payload_len], counting only
    the valid entries when total_len is not a multiple of payload_len (the
    reference's strided ``.mean()``).
    """
    reps = -(-total_len // payload_len)
    pad = reps * payload_len - total_len
    x = torch.nn.functional.pad(wm_flat, (0, pad))
    x = x.reshape(*wm_flat.shape[:-1], reps, payload_len)
    counts = torch.tensor(
        [(total_len - i + payload_len - 1) // payload_len for i in range(payload_len)],
        dtype=torch.float32, device=wm_flat.device)
    return torch.sum(x, dim=-2) / counts


def _unshuffle(vals: torch.Tensor, key) -> torch.Tensor:
    """Invert the keyed shuffle: out[..., idx] = vals."""
    idx = torch.as_tensor(keyed_shuffle_indices(key, vals.shape[-1]), device=vals.device)
    out = torch.zeros_like(vals)
    out[..., idx] = vals
    return out


def _threshold_mid(vals: torch.Tensor) -> torch.Tensor:
    """Binarize at the midpoint of (min, max), as the reference does.  A
    constant payload is unrecoverable under this rule once any mean wobbles;
    ``'fixed'`` avoids that for 0/1 planes."""
    thr = 0.5 * (torch.amax(vals, dim=-1, keepdim=True) + torch.amin(vals, dim=-1, keepdim=True))
    return (vals > thr).to(torch.uint8)


def _threshold_fixed(vals: torch.Tensor) -> torch.Tensor:
    """Binarize at absolute 0.5: exact for 0/1 bit planes, robust for constant payloads."""
    return (vals > 0.5).to(torch.uint8)


class Shuffler:
    """Bit-payload spreader: keyed shuffle + tile to capacity."""

    wm_kind = "bits"

    def __init__(self, key=None):
        self.key = key

    @staticmethod
    def wm_type() -> str:
        return "bits"

    def generate_wm(self, payload: np.ndarray, capacity) -> np.ndarray:
        total = int(np.prod(np.asarray(capacity)))
        p = np.array(payload).flatten().copy()
        np.random.RandomState(self.key).shuffle(p)
        return _tile_to(p, total).reshape(capacity)


class DeShuffler:
    """Inverse of :class:`Shuffler`: strided mean, unshuffle, threshold.

    ``threshold='midpoint'`` reproduces the reference exactly; ``'fixed'``
    binarizes at absolute 0.5 (see :func:`_threshold_mid`).
    """

    def __init__(self, key=None, threshold: str = "midpoint"):
        self.key = key
        self.payload_len = None
        self._thr = _threshold_fixed if threshold == "fixed" else _threshold_mid

    def set_shape(self, payload_shape):
        self.payload_shape = tuple(np.atleast_1d(payload_shape))
        self.payload_len = int(np.prod(np.asarray(payload_shape)))
        return self

    def degenerate_batch(self, wm: torch.Tensor) -> torch.Tensor:
        """[..., total] float watermark plane(s) -> [..., payload_len] uint8 bits."""
        means = despread_mean(wm, self.payload_len, wm.shape[-1])
        return self._thr(_unshuffle(means, self.key))

    def degenerate(self, wm) -> np.ndarray:
        """Single-plane NumPy-compatible entry point (reference API shape)."""
        flat = torch.as_tensor(np.asarray(wm, np.float32)).reshape(1, -1)
        return self.degenerate_batch(flat)[0].numpy()
