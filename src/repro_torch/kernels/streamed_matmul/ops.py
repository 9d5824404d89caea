"""Public GEMM wrapper: the counterpart of
``repro.kernels.streamed_matmul.ops.matmul``.  The caller's arrays are
not padded: the fp32 kernel's pre-pass writes its padded, split operands
into scratch of its own, and the bf16 kernel masks ragged edges."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.streamed_matmul.kernel import DTYPES, matmul_cuda
from repro_torch.kernels.streamed_matmul.ref import matmul_ref


def matmul(a, b, *, use_kernel: bool = True):
    """(M, K) @ (K, N) with an fp32 accumulator; the result has a's dtype.

    CPU tensors, or ``use_kernel=False``, take the plain PyTorch version.
    CUDA tensors go to the kernel, which takes contiguous fp32 or bf16
    operands of one dtype, or raise.  ``matmul.launches`` counts the
    kernels launched: one a bf16 call; for fp32, for each K panel of at
    most 8,192, two split pre-passes and the product's grid in launches of
    16 waves (180 at M = N = K = 33,842 on 132 SMs).  fp32 allocates split
    scratch for one panel beside the output (``matmul_cuda``).
    """
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul: cannot multiply {tuple(a.shape)} by "
                         f"{tuple(b.shape)}")
    if not use_kernel or a.device.type == "cpu":
        return matmul_ref(a, b)
    _build.require("matmul", (a, b), DTYPES)
    if a.dtype != b.dtype:
        raise TypeError(f"matmul: operands differ in dtype: {a.dtype}, {b.dtype}")
    c = torch.empty((a.shape[0], b.shape[1]), dtype=a.dtype, device=a.device)
    if c.numel():
        matmul.launches += matmul_cuda(a, b, c)
    return c


matmul.launches = 0
