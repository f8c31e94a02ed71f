"""``python -m vfp_tpu_torch.cli`` — see ``__main__.py``."""

from .__main__ import main  # noqa: F401
