"""Plain PyTorch Black-Scholes: the counterpart of
``repro.kernels.black_scholes.ref`` and the oracle of the CUDA kernel."""
from __future__ import annotations

import math

import torch


def ncdf(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


def black_scholes_ref(s, x, t, r: float, v: float):
    """s: spot, x: strike, t: expiry (same shape). Returns (call, put) in
    the inputs' dtype; the math is fp32."""
    sf, xf, tf = (a.float() for a in (s, x, t))
    sqrt_t = torch.sqrt(tf)
    d1 = (torch.log(sf / xf) + (r + 0.5 * v * v) * tf) / (v * sqrt_t)
    d2 = d1 - v * sqrt_t
    disc = torch.exp(-r * tf)
    call = sf * ncdf(d1) - xf * disc * ncdf(d2)
    put = xf * disc * ncdf(-d2) - sf * ncdf(-d1)
    return call.to(s.dtype), put.to(s.dtype)
