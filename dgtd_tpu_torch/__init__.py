"""dgtd_tpu_torch: the PyTorch/CUDA port of ``dgtd_tpu``.

The package mirrors ``dgtd_tpu``'s module layout so each piece has an obvious
counterpart; the JAX package stays the numerical reference. This package
imports ``torch`` and ``numpy`` only, never ``jax``, ``flax`` or ``dgtd_tpu``.
Hand-written Hopper kernels live in ``csrc/`` and are built with ``nvcc`` at
first use (``ops/_build.py``).
"""
