"""vfp_tpu_torch — the flagship watermark codec in PyTorch, with CUDA kernels.

A port of ``vfp_tpu`` (JAX/Pallas on a TPU) to PyTorch on an NVIDIA H100.
Module names mirror the JAX package, so each module's counterpart is found
under the same path there; ``vfp_tpu`` stays the reference the tests hold
this package against.

The package imports ``torch`` and numpy, never ``jax``.  It shares the
JAX-free ``vfp_tpu.io``, ``vfp_tpu.native`` and ``vfp_tpu.utils.config``.
The CUDA kernels under ``csrc/`` are compiled with nvcc at their first launch
(``kernels/_build.py``); importing the package builds nothing.
"""

__version__ = "0.1.0"
