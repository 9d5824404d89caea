"""The precision of the reference's products.

``FP32``: every product in fp32 with TF32 off.  ``FP8``: both operands of
every product rounded to fp8 e4m3 (a per-tensor scale that maps the
largest magnitude to e4m3's largest, 448) and the product taken in fp32,
which is what an fp8 tensor-core product computes; the rounding passes
gradients straight through, so backward products take the rounded saved
operands.  ``FP8`` is the control: the step below the served bf16.
"""
from __future__ import annotations

import torch

E4M3_MAX = 448.0


def exact_fp32() -> None:
    """fp32 products in fp32: no TF32 for matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def to_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to fp8 e4m3 under one scale, back in fp32; the
    gradient passes through unchanged."""
    with torch.no_grad():
        scale = x.detach().abs().amax().clamp_min(1e-30) / E4M3_MAX
        q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (q - x).detach() if x.requires_grad else q


def fp32_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b)


def fp8_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(to_fp8(a), to_fp8(b))


FP32 = fp32_mm
FP8 = fp8_mm
PRECISIONS = {"fp32": FP32, "fp8": FP8}
