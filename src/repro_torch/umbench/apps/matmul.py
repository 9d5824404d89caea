"""cuBLAS — single-precision GEMM (paper Table I).

Advise: READ_MOSTLY on A and B (constant inputs).  Prefetch: A and B.
``workload()`` builds the trace; variant lowering lives in
``umbench.variants``.

``numeric()`` computes it for real.
"""
from __future__ import annotations

import math

import torch

from repro_torch.device import resolve
from repro_torch.kernels import matmul as mm_kernel
from repro_torch.kernels.streamed_matmul.ref import matmul_ref
from repro_torch.umbench.workload import Workload, WorkloadBuilder

NAME = "cublas"
ITERS = 4


def workload(total_bytes: float, iters: int = ITERS) -> Workload:
    nb = int(total_bytes) // 3
    n = int(math.sqrt(nb / 4))
    w = WorkloadBuilder(NAME)
    for nm in ("A", "B"):
        w.alloc(nm, nb, role="input")
        w.host_write(nm)
        w.advise_read_mostly(nm)
        w.prefetch(nm)
    w.alloc("C", nb, role="output")

    for _ in range(iters):
        w.kernel("gemm", flops=2.0 * n**3, reads=("A", "B"), writes=("C",))
    w.readback("C")
    return w.build()


def numeric(seed: int = 0, n: int = 512, device=None):
    """C = A @ B for two N(0, 1) fp32 n x n matrices."""
    dev = resolve(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randn(n, n, generator=g, device=dev)
    b = torch.randn(n, n, generator=g, device=dev)
    return {"a": a, "b": b, "c": mm_kernel(a, b), "c_ref": matmul_ref(a, b)}
