"""Binding of the CUDA FDTD3d stencil (``csrc/fdtd3d.cu``), which replaces
the Pallas TPU kernel ``_fdtd_kernel`` of ``repro.kernels.fdtd3d.kernel``.
Memory-bound: 8 bytes moved per cell; it reads the unpadded grid and clamps
its neighbours to the edge; see the source for the design."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

_ARGS = (_build.PTR,) * 3 + (_build.I64,) * 3


def fdtd3d_cuda(grid: torch.Tensor, coeffs: torch.Tensor,
                out: torch.Tensor) -> None:
    """One stencil step from a checked, non-empty fp32 grid into ``out``,
    which must not overlap it."""
    Z, Y, X = grid.shape
    _build.launch("um_fdtd3d_f32", _ARGS, grid.data_ptr(), coeffs.data_ptr(),
                  out.data_ptr(), Z, Y, X, device=grid.device)
