"""Configuration (copied from the JAX package's) and the codec factory, the
trace decorator and the profiling hooks."""

from .config import CodecConfig, ServeConfig, VfpConfig, WorkflowConfig, make_codec  # noqa: F401
from .logging import trace  # noqa: F401
from .profiling import StageTimer, profile_trace  # noqa: F401
