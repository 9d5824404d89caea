"""Hand-written Hopper (sm_90a) CUDA kernels for the compute hot spots of
the paper's apps and for flash and paged attention, each the counterpart
of a Pallas TPU kernel in ``repro.kernels``.

Each subpackage: kernel.py (ctypes binding of its ``csrc/*.cu`` source),
ops.py (the public wrapper: checks, launch counter, plain version for CPU
tensors), ref.py (the plain PyTorch version the kernel is held against).
``_build`` compiles every source in ``csrc/`` at first use, one ``nvcc``
process per source, all started together, and links them into one
library.
"""
from repro_torch.kernels.black_scholes.ops import black_scholes
from repro_torch.kernels.fdtd3d.ops import fdtd3d_run, fdtd3d_step
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.kernels.streamed_matmul.ops import matmul

__all__ = ["black_scholes", "fdtd3d_run", "fdtd3d_step", "flash_attention",
           "matmul", "paged_attention"]
