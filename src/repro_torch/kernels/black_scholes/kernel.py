"""Binding of the CUDA Black-Scholes kernel (``csrc/black_scholes.cu``),
which replaces the Pallas TPU kernel ``bs_kernel`` of
``repro.kernels.black_scholes.kernel``.  Memory-bound: 20 bytes moved per
option; see the source for the design."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_ARGS = (_build.PTR,) * 5 + (_build.I64, _build.F64, _build.F64)


def black_scholes_cuda(s: torch.Tensor, x: torch.Tensor, t: torch.Tensor,
                       call: torch.Tensor, put: torch.Tensor,
                       r: float, v: float) -> None:
    """Write the prices of the non-empty, checked fp32 inputs into
    ``call`` and ``put``."""
    _build.launch("um_black_scholes_f32", _ARGS, s.data_ptr(), x.data_ptr(),
                  t.data_ptr(), call.data_ptr(), put.data_ptr(), s.numel(),
                  float(r), float(v), device=s.device)
