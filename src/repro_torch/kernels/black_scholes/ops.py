"""Public Black-Scholes wrapper: the counterpart of
``repro.kernels.black_scholes.ops.black_scholes``."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.black_scholes.kernel import black_scholes_cuda
from repro_torch.kernels.black_scholes.ref import black_scholes_ref


def black_scholes(s, x, t, *, r: float = 0.02, v: float = 0.30,
                  use_kernel: bool = True):
    """Price European options; inputs of any one shape.  Returns (call, put).

    CPU tensors, or ``use_kernel=False``, take the plain PyTorch version.
    CUDA tensors go to the kernel, which takes contiguous fp32, or raise.
    ``black_scholes.launches`` counts the kernel's launches.
    """
    if not s.shape == x.shape == t.shape:
        raise ValueError(f"black_scholes: shapes differ: {s.shape}, "
                         f"{x.shape}, {t.shape}")
    if not use_kernel or s.device.type == "cpu":
        return black_scholes_ref(s, x, t, r, v)
    _build.require("black_scholes", (s, x, t), (torch.float32,))
    call, put = torch.empty_like(s), torch.empty_like(s)
    if s.numel():
        black_scholes_cuda(s, x, t, call, put, r, v)
        black_scholes.launches += 1
    return call, put


black_scholes.launches = 0
