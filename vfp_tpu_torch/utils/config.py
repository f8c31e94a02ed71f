"""One typed configuration for the library and the CLI, and the codec factory.

The dataclasses are this package's own copies of ``vfp_tpu/utils/config.py``,
with the same fields and defaults, so a JSON configuration written for the
JAX package loads here unchanged.  ``fast_dots`` is kept for that reason
only: the port computes in float32 and ignores it.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field


@dataclass
class CodecConfig:
    # DwtDctSvd
    scales: tuple = (0.0, 15.0, 0.0)
    blk: int = 4
    backend: str = "auto"  # pallas | xla | auto (the JAX names; kernel | torch | auto here)
    # DctQim
    alpha_dct: float = 20.0
    # Dtcwt
    alpha_key: float = 10.0
    alpha_img: float = 1.5
    step: float = 5.0
    # single-bf16-pass matmuls of the JAX package's kernels; ignored by the port
    fast_dots: bool = False


@dataclass
class WorkflowConfig:
    segment_duration: float = 2.0
    copies: int = 3
    key: int = 0
    batch_size: int = 16
    quality: int = 95
    verify_threshold: float = 0.5  # majority frequency bar per segment
    preservation_threshold: float = 0.75  # durability pass bar
    correlation_threshold: float = 0.1  # spread-spectrum presence


@dataclass
class ServeConfig:
    host: str = "0.0.0.0"
    port: int = 8000
    data_dir: str = "serve_data"


@dataclass
class VfpConfig:
    codec: CodecConfig = field(default_factory=CodecConfig)
    workflow: WorkflowConfig = field(default_factory=WorkflowConfig)
    serve: ServeConfig = field(default_factory=ServeConfig)

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "VfpConfig":
        return cls(
            codec=CodecConfig(**d.get("codec", {})),
            workflow=WorkflowConfig(**d.get("workflow", {})),
            serve=ServeConfig(**d.get("serve", {})),
        )

    @classmethod
    def load(cls, path) -> "VfpConfig":
        import json

        with open(path) as f:
            return cls.from_dict(json.load(f))

    def make_codec(self, name: str):
        """Codec factory: 'dwtDctSvd' | 'dct' | 'dtcwtKey' | 'dtcwtImg' (the
        module function with this configuration)."""
        return make_codec(name, self)


def make_codec(name: str, config: VfpConfig | None = None):
    """'dwtDctSvd' | 'dct' | 'dtcwtKey' | 'dtcwtImg' -> this package's codec, configured
    from ``config.codec`` (the JAX backend names map as pallas -> kernel,
    xla -> torch)."""
    from ..wm.dct_qim import DctQim
    from ..wm.dtcwt_codecs import DtcwtImg, DtcwtKey
    from ..wm.dwt_dct_svd import REFERENCE_BACKENDS, DwtDctSvd

    c = (config or VfpConfig()).codec
    key = name.lower()
    if key in ("dwtdctsvd", "dwt_dct_svd", "svd"):
        return DwtDctSvd(scales=tuple(c.scales), blk=c.blk,
                         backend=REFERENCE_BACKENDS.get(c.backend, c.backend))
    if key in ("dct", "dctqim", "dct_qim"):
        return DctQim(alpha=c.alpha_dct)
    if key in ("dtcwtkey", "dtcwt_key"):
        return DtcwtKey(alpha=c.alpha_key, step=c.step)
    if key in ("dtcwtimg", "dtcwt_img"):
        return DtcwtImg(alpha=c.alpha_img, step=c.step)
    raise ValueError(f"unknown codec: {name}")
