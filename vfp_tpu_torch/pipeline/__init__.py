"""Host pipelines: overlap video I/O with batched device compute."""

from .embedder import Embedder, FrameMarker, MultiMarker, PipelineStats  # noqa: F401
from .extractor import ExtractResult, Extractor, FrameExtractor, cached_bit_extractor  # noqa: F401
