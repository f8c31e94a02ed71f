"""End-to-end experiments of the port (``vfp_tpu/workflows/``): the
durability experiment, mark -> segment -> lossy re-encode -> splice ->
re-segment -> detect."""

from .durability import payload_for_segment_8bit, run_durability, run_durability_corr  # noqa: F401
