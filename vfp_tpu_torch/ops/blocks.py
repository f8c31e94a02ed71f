"""Image <-> non-overlapping block-batch layout transforms (port of
``vfp_tpu/ops/blocks.py``).

The whole image is reshaped once into a [..., Nblocks, blk, blk] batch so
per-block math runs as one vectorised program.  Blocks are in row-major
order over the block grid, which payload indexing depends on.
"""

from __future__ import annotations

import torch


def to_blocks(img: torch.Tensor, blk: int) -> torch.Tensor:
    """[..., H, W] (H, W multiples of blk) -> [..., (H/blk)*(W/blk), blk, blk]."""
    *lead, h, w = img.shape
    nbh, nbw = h // blk, w // blk
    x = img.reshape(*lead, nbh, blk, nbw, blk).transpose(-3, -2)  # [..., nbh, nbw, blk, blk]
    return x.reshape(*lead, nbh * nbw, blk, blk)


def from_blocks(blocks: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Inverse of :func:`to_blocks`; returns [..., h, w]."""
    *lead, _, blk, _ = blocks.shape
    nbh, nbw = h // blk, w // blk
    x = blocks.reshape(*lead, nbh, nbw, blk, blk).transpose(-3, -2)
    return x.reshape(*lead, h, w)
