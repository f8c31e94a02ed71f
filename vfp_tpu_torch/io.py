"""Frame I/O of the port: the JAX package's own ``vfp_tpu.io``, which imports
no jax.  Use ``.rawv`` (exact uint8): the other containers need cv2, and
``.y4m`` pulls in jax through ``vfp_tpu.ops.color`` and is lossy 4:2:0."""

from vfp_tpu.io import RawVideoReader, RawVideoWriter, open_reader, open_writer  # noqa: F401
