"""Host pipelines: overlap video I/O with batched device compute."""

from .embedder import Embedder, FrameMarker, MultiMarker, PipelineStats, use_lowlink  # noqa: F401
from .extractor import ExtractResult, Extractor, FrameExtractor, cached_bit_extractor  # noqa: F401
from .lowlink import (LowLinkExtractor, LowLinkMarker, PackedTwoPlane,  # noqa: F401
                      host_ll, reconstruct)
