"""Tensor ops of the ported codecs: colour, Haar DWT, 8x8 DCT, SoA block layout,
image <-> block batches and the tiny batched SVD."""

from .blocks import from_blocks, to_blocks  # noqa: F401
from .svd4 import top_singular_triplet, top_singular_value  # noqa: F401
