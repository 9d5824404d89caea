"""PyTorch/CUDA port of the paper's benchmark suite, for an NVIDIA H100.

The counterpart of the JAX package ``repro``, which stays the reference.
This package imports torch and numpy, never JAX and nothing of ``repro``.
Entry points run on the CUDA card unless the caller passes
``device="cpu"``, which takes the kernels' plain PyTorch versions.
"""
