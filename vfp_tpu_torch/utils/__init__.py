"""Configuration shared with the JAX package."""

from .config import CodecConfig, VfpConfig, make_codec  # noqa: F401
