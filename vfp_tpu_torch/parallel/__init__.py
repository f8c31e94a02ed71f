"""Scaling over processes and devices: device meshes, sharded mark/detect
steps and the segment farm (port of ``vfp_tpu/parallel/``)."""

from .mesh import make_mesh  # noqa: F401
from .sharded import sharded_detect_step, sharded_mark_step  # noqa: F401
from .farm import (  # noqa: F401
    mark_segments_distributed,
    mark_segments_parallel,
    merge_manifest_shards,
)
