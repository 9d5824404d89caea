"""FDTD3d: 3-D finite-difference time domain (paper Table I), computed for
real."""
from __future__ import annotations

import torch

from repro_torch.device import resolve
from repro_torch.kernels import fdtd3d_run
from repro_torch.kernels.fdtd3d.ref import fdtd3d_step_ref

NAME = "fdtd3d"
COEFFS = (0.55, 0.1, 0.02, 0.008, 0.002)


def numeric(seed: int = 0, shape=(16, 24, 136), steps: int = 3, device=None):
    """``steps`` stencil steps over an N(0, 1) fp32 grid of ``shape``."""
    dev = resolve(device)
    g = torch.Generator(device=dev).manual_seed(seed)
    grid = torch.randn(*shape, generator=g, device=dev)
    coeffs = torch.tensor(COEFFS, dtype=torch.float32, device=dev)
    out = fdtd3d_run(grid, coeffs, steps=steps)
    ref = grid
    for _ in range(steps):
        ref = fdtd3d_step_ref(ref, coeffs)
    return {"grid": grid, "coeffs": coeffs, "out": out, "ref": ref}
