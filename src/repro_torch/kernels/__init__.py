"""Hand-written Hopper (sm_90a) CUDA kernels for the compute hot spots of
the paper's apps, each the counterpart of a Pallas TPU kernel in
``repro.kernels``.

Each subpackage: kernel.py (ctypes binding of its ``csrc/*.cu`` source),
ops.py (the public wrapper: checks, launch counter, plain version for CPU
tensors), ref.py (the plain PyTorch version the kernel is held against).
``_build`` compiles every source in ``csrc/`` with one ``nvcc`` call at
first use.
"""
from repro_torch.kernels.black_scholes.ops import black_scholes
from repro_torch.kernels.fdtd3d.ops import fdtd3d_run, fdtd3d_step
from repro_torch.kernels.streamed_matmul.ops import matmul

__all__ = ["black_scholes", "fdtd3d_run", "fdtd3d_step", "matmul"]
