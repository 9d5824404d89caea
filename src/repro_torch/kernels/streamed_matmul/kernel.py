"""Binding of the CUDA tiled GEMM (``csrc/streamed_matmul.cu``), which
replaces the Pallas TPU kernel ``mm_kernel`` of
``repro.kernels.streamed_matmul.kernel``.  Compute-bound at the paper's
size; IEEE fp32 FMAs, no TF32; see the source for the design."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_ARGS = (_build.PTR,) * 3 + (_build.I64,) * 3
_ENTRY = {torch.float32: "um_gemm_f32", torch.bfloat16: "um_gemm_bf16"}
DTYPES = tuple(_ENTRY)


def matmul_cuda(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> None:
    """c = a @ b for checked (M, K) and (K, N) inputs with M, N > 0."""
    (M, K), N = a.shape, b.shape[1]
    _build.launch(_ENTRY[a.dtype], _ARGS, a.data_ptr(), b.data_ptr(),
                  c.data_ptr(), M, N, K, device=a.device)
