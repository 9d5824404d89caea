"""cuBLAS: single-precision GEMM (paper Table I), computed for real."""
from __future__ import annotations

import torch

from repro_torch.device import resolve
from repro_torch.kernels import matmul as mm_kernel
from repro_torch.kernels.streamed_matmul.ref import matmul_ref

NAME = "cublas"


def numeric(seed: int = 0, n: int = 512, device=None):
    """C = A @ B for two N(0, 1) fp32 n x n matrices."""
    dev = resolve(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randn(n, n, generator=g, device=dev)
    b = torch.randn(n, n, generator=g, device=dev)
    return {"a": a, "b": b, "c": mm_kernel(a, b), "c_ref": matmul_ref(a, b)}
