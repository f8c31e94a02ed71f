"""Hand-written CUDA kernels of the flagship codec, each beside its plain
PyTorch version.  Importing this package builds nothing and needs no nvcc:
the kernels are compiled at their first launch (``_build.py``)."""

from .fused_embed import fused_extract_planar, fused_mark_planar  # noqa: F401
from .qim import qim_decode_soa, qim_embed_soa, qim_triplet_soa  # noqa: F401

KERNELS = (fused_mark_planar, fused_extract_planar, qim_triplet_soa, qim_decode_soa,
           qim_embed_soa)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}
