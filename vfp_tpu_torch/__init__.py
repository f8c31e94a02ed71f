"""vfp_tpu_torch — the ported watermark codecs in PyTorch, with CUDA kernels.

A port of ``vfp_tpu`` (JAX/Pallas on a TPU) to PyTorch on an NVIDIA H100.
Module names mirror the JAX package, so each module's counterpart is found
under the same path there; ``vfp_tpu`` stays the reference the tests hold
this package against.

The package imports ``torch`` and numpy, never ``jax`` and nothing of
``vfp_tpu``: what it needs of the JAX package's JAX-free modules (``.rawv``
I/O, the native streaming engine, the configuration) it keeps as its own
copies under ``io/``, ``native/`` and ``utils/``.  The CUDA kernels under
``csrc/`` are compiled with nvcc at their first launch
(``kernels/_build.py``) and the native I/O library with g++ at its first
use (``native/build.py``); importing the package builds nothing.
"""

__version__ = "0.2.0"
