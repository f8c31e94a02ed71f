"""Frame content drawn from the seed on the device, in a few large calls.

``natural``: coarse noise upsampled 8x by repetition plus mild grain (the
flagship codec's smoke content).  ``smooth``: coarse noise upsampled 16x
bilinearly plus mild grain, the compressible content the DT-CWT key codec
is specified on.  Both are uint8 BGR [n, H, W, 3], truncated as NumPy's
``astype(np.uint8)`` truncates.
"""

from __future__ import annotations

import numpy as np
import torch

CHUNK = 8  # frames a call: bounds the float32 scratch at 1080p to ~200 MB


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2**63))
    return g


def _natural(g, n, h, w, device):
    small = torch.rand((n, -(-h // 8), -(-w // 8), 3), generator=g, device=device)
    f = small.repeat_interleave(8, 1).repeat_interleave(8, 2)[:, :h, :w] * 220
    f = f + torch.rand((n, h, w, 3), generator=g, device=device) * 20
    return torch.clamp(f, 0, 255).to(torch.uint8)


def _smooth(g, n, h, w, device):
    small = torch.rand((n, 3, h // 16 + 2, w // 16 + 2), generator=g, device=device)
    f = torch.nn.functional.interpolate(small, size=(h, w), mode="bilinear",
                                        align_corners=False).permute(0, 2, 3, 1)
    f = f * 235 + torch.rand((n, h, w, 3), generator=g, device=device) * 12
    return torch.clamp(f, 0, 255).to(torch.uint8)


KINDS = {"natural": _natural, "smooth": _smooth}


def make(kind: str, g: torch.Generator, n: int, h: int, w: int, device) -> np.ndarray:
    """[n, H, W, 3] uint8 frames in host memory (pageable, as a decoder's)."""
    out = np.empty((n, h, w, 3), np.uint8)
    fn = KINDS[kind]
    for i in range(0, n, CHUNK):
        k = min(CHUNK, n - i)
        out[i:i + k] = fn(g, k, h, w, device).cpu().numpy()
    return out
