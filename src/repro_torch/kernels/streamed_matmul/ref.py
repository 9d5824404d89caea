"""Plain PyTorch GEMM: the counterpart of
``repro.kernels.streamed_matmul.ref`` and the oracle of the CUDA kernel."""
from __future__ import annotations

import torch


def matmul_ref(a: torch.Tensor, b: torch.Tensor, out_dtype=None):
    """a @ b with an fp32 product, cast to ``out_dtype`` (default a.dtype).

    On a CUDA card this is full fp32 only while TF32 is off for matrix
    products (``torch.backends.cuda.matmul.allow_tf32``, False by default).
    """
    return torch.matmul(a.float(), b.float()).to(out_dtype or a.dtype)
