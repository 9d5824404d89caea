"""Plain PyTorch FDTD3d stencil: the counterpart of
``repro.kernels.fdtd3d.ref`` and the oracle of the CUDA kernel.

out[z,y,x] = c0*in + sum_r c_r * (6 neighbours at distance r along each
axis) over an edge-padded grid: the CUDA FDTD3d sample's stencil.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

RADIUS = 4


def pad_edge(grid: torch.Tensor) -> torch.Tensor:
    """Pad a (Z, Y, X) grid by RADIUS on every face with its edge values
    (``jnp.pad(mode="edge")``)."""
    return F.pad(grid[None, None], (RADIUS,) * 6, mode="replicate")[0, 0]


def fdtd3d_ref(padded: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    """padded: (Z+2R, Y+2R, X+2R); coeffs: (RADIUS+1,). Returns (Z, Y, X).

    Sums in the JAX oracle's order, but accumulates in place: at the
    paper's 1.7 G cells a temporary per term would not fit the card.
    """
    R = RADIUS
    Z, Y, X = (s - 2 * R for s in padded.shape)
    c = coeffs.float()
    p = padded.float()
    out = c[0] * p[R:R + Z, R:R + Y, R:R + X]
    for r in range(1, R + 1):
        ring = p[R - r:R - r + Z, R:R + Y, R:R + X] + p[R + r:R + r + Z, R:R + Y, R:R + X]
        ring += p[R:R + Z, R - r:R - r + Y, R:R + X]
        ring += p[R:R + Z, R + r:R + r + Y, R:R + X]
        ring += p[R:R + Z, R:R + Y, R - r:R - r + X]
        ring += p[R:R + Z, R:R + Y, R + r:R + r + X]
        out.addcmul_(ring, c[r])
    return out.to(padded.dtype)


def fdtd3d_step_ref(grid: torch.Tensor, coeffs: torch.Tensor) -> torch.Tensor:
    return fdtd3d_ref(pad_edge(grid), coeffs)
