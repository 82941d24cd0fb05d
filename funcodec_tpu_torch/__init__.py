"""PyTorch/CUDA port of funcodec_tpu for one NVIDIA Hopper card.

The JAX package ``funcodec_tpu`` is the reference this package is held
against; module names mirror it file for file. This package imports
``torch`` and never ``jax``. Hand-written CUDA kernels live in ``csrc/`` and
are built at first use by ``kernels/build.py``.
"""
