"""Public FDTD3d wrappers: the counterparts of
``repro.kernels.fdtd3d.ops.fdtd3d_step`` and ``fdtd3d_run``.  The kernel
clamps neighbour indices to the edge, so no padded copy is made and Z need
not be a multiple of 8."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.fdtd3d.kernel import fdtd3d_cuda
from repro_torch.kernels.fdtd3d.ref import RADIUS, fdtd3d_step_ref


def _on_kernel(grid, coeffs, use_kernel: bool) -> bool:
    if grid.ndim != 3 or tuple(coeffs.shape) != (RADIUS + 1,):
        raise ValueError(f"fdtd3d: want a (Z, Y, X) grid and {RADIUS + 1} "
                         f"coefficients, got {tuple(grid.shape)} and "
                         f"{tuple(coeffs.shape)}")
    if not use_kernel or grid.device.type == "cpu":
        return False
    _build.require("fdtd3d", (grid, coeffs), (torch.float32,))
    return True


def _launch(grid, coeffs, out) -> None:
    if grid.numel():
        fdtd3d_cuda(grid, coeffs, out)
        fdtd3d_step.launches += 1


def fdtd3d_step(grid, coeffs, *, use_kernel: bool = True):
    """One 8th-order stencil application to a (Z, Y, X) grid.

    CPU tensors, or ``use_kernel=False``, take the plain PyTorch version.
    CUDA tensors go to the kernel, which takes contiguous fp32, or raise.
    ``fdtd3d_step.launches`` counts the kernel's launches, those made by
    ``fdtd3d_run`` included.
    """
    if not _on_kernel(grid, coeffs, use_kernel):
        return fdtd3d_step_ref(grid, coeffs)
    out = torch.empty_like(grid)
    _launch(grid, coeffs, out)
    return out


def fdtd3d_run(grid, coeffs, steps: int = 4, *, use_kernel: bool = True):
    """``steps`` time steps, the output of step k feeding step k+1.  On the
    kernel path two buffers alternate, and ``grid`` is left as it was."""
    if steps < 0:
        raise ValueError(f"fdtd3d_run: steps must be >= 0, got {steps}")
    if not _on_kernel(grid, coeffs, use_kernel):
        for _ in range(steps):
            grid = fdtd3d_step_ref(grid, coeffs)
        return grid
    bufs = [torch.empty_like(grid) for _ in range(min(steps, 2))]
    src = grid
    for i in range(steps):
        _launch(src, coeffs, bufs[i % 2])
        src = bufs[i % 2]
    return src


fdtd3d_step.launches = 0
