"""Codec factory over the configuration the JAX package defines.

``VfpConfig``/``CodecConfig`` are ``vfp_tpu.utils.config``'s own (that module
imports no jax); only the factory is this package's, since it builds this
package's codec.
"""

from __future__ import annotations

from vfp_tpu.utils.config import CodecConfig, VfpConfig  # noqa: F401

_UNPORTED = ("dct", "dctqim", "dct_qim", "dtcwtkey", "dtcwt_key", "dtcwtimg", "dtcwt_img")


def make_codec(name: str, config: VfpConfig | None = None):
    """'dwtDctSvd' -> this package's DwtDctSvd, configured from ``config.codec``
    (its JAX backend names map as pallas -> kernel, xla -> torch)."""
    from ..wm.dwt_dct_svd import REFERENCE_BACKENDS, DwtDctSvd

    c = (config or VfpConfig()).codec
    key = name.lower()
    if key in ("dwtdctsvd", "dwt_dct_svd", "svd"):
        return DwtDctSvd(scales=tuple(c.scales), blk=c.blk,
                         backend=REFERENCE_BACKENDS.get(c.backend, c.backend))
    if key in _UNPORTED:
        raise NotImplementedError(f"codec {name!r} is not ported to vfp_tpu_torch yet "
                                  "(ROADMAP.md queue 1)")
    raise ValueError(f"unknown codec: {name}")
