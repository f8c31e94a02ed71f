"""HTTP serving layer (port of ``vfp_tpu/serve``): upload -> watermark ->
per-viewer HLS -> leak detection, on the service's device."""

from .service import VfpService  # noqa: F401
