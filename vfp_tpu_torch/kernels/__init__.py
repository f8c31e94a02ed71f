"""Hand-written CUDA kernels of the ported codecs, each beside its plain
PyTorch version.  Importing this package builds nothing and needs no nvcc:
the kernels are compiled at their first launch (``_build.py``)."""

from .dtcwt_delta import dtcwt_delta_synthesis  # noqa: F401
from .dtcwt_level1 import (dtcwt_level1_analysis, dtcwt_level1_analysis_ll,  # noqa: F401
                           dtcwt_level1_ll_color, dtcwt_level1_ll_y, dtcwt_qshift_analysis,
                           dtcwt_qshift_hp, dtcwt_qshift_ll)
from .dtcwt_masks import dtcwt_qshift_masks  # noqa: F401
from .dtcwt_synthesis import (dtcwt_legall_synthesis, dtcwt_legall_synthesis_hp,  # noqa: F401
                              dtcwt_legall_synthesis_ll, dtcwt_qshift_synthesis,
                              dtcwt_qshift_synthesis_ll)
from .fused_dct_qim import fused_dct_qim_extract, fused_dct_qim_mark, y_dc_mean  # noqa: F401
from .fused_embed import fused_extract_planar, fused_mark_planar  # noqa: F401
from .qim import qim_decode_soa, qim_embed_soa, qim_triplet_soa  # noqa: F401

KERNELS = (fused_mark_planar, fused_extract_planar, qim_triplet_soa, qim_decode_soa,
           qim_embed_soa, fused_dct_qim_mark, fused_dct_qim_extract, y_dc_mean,
           dtcwt_level1_ll_y, dtcwt_qshift_masks, dtcwt_delta_synthesis, dtcwt_level1_analysis,
           dtcwt_level1_ll_color, dtcwt_qshift_ll, dtcwt_qshift_hp, dtcwt_legall_synthesis_hp,
           dtcwt_level1_analysis_ll, dtcwt_qshift_analysis, dtcwt_qshift_synthesis,
           dtcwt_qshift_synthesis_ll, dtcwt_legall_synthesis, dtcwt_legall_synthesis_ll)


# the extract's second kernel (fused_dct_qim.cu decide_kernel), counted apart
EXTRACT_DECIDE = "fused_dct_qim_extract.decide"
# the flagship kernels' integer bodies (int_path=True), counted apart
MARK_INT = "fused_mark_planar.int"
EXTRACT_INT = "fused_extract_planar.int"


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
    fused_dct_qim_extract.decide_launches = 0
    fused_mark_planar.int_launches = 0
    fused_extract_planar.int_launches = 0


def launch_counts() -> dict:
    """{wrapper name: its kernel's launches}, the extract's second kernel's
    under ``EXTRACT_DECIDE`` and the flagship integer bodies' under
    ``MARK_INT`` and ``EXTRACT_INT``."""
    return {**{k.__name__: k.launches for k in KERNELS},
            EXTRACT_DECIDE: fused_dct_qim_extract.decide_launches,
            MARK_INT: fused_mark_planar.int_launches,
            EXTRACT_INT: fused_extract_planar.int_launches}
