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


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 values rounded to TF32 (10 bits of mantissa), to nearest with
    ties away from zero, on the bits: what ``cvt.rna.tf32.f32`` gives."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_tf32_ref(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) = (tf32(x), tf32(x - hi)): the GEMM kernel's split pre-pass,
    before its transpose and padding.  x - hi is exact in fp32."""
    hi = tf32_round(x)
    return hi, tf32_round(x.float() - hi)
