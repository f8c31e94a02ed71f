"""Configuration (copied from the JAX package's) and the codec factory."""

from .config import CodecConfig, ServeConfig, VfpConfig, WorkflowConfig, make_codec  # noqa: F401
