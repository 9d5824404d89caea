"""BS: Black-Scholes option pricing (paper Table I), computed for real."""
from __future__ import annotations

import torch

from repro_torch.device import resolve
from repro_torch.kernels import black_scholes as bs_kernel
from repro_torch.kernels.black_scholes.ref import black_scholes_ref

NAME = "bs"


def numeric(seed: int = 0, n: int = 4096, device=None):
    """Price n options with S in [5, 30), X in [1, 100), T in [0.25, 10)."""
    dev = resolve(device)
    g = torch.Generator(device=dev).manual_seed(seed)

    def uniform(lo, hi):
        return torch.empty(n, device=dev).uniform_(lo, hi, generator=g)

    s, x, t = uniform(5.0, 30.0), uniform(1.0, 100.0), uniform(0.25, 10.0)
    call, put = bs_kernel(s, x, t)
    call_ref, put_ref = black_scholes_ref(s, x, t, 0.02, 0.30)
    return {"s": s, "x": x, "t": t, "call": call, "put": put,
            "call_ref": call_ref, "put_ref": put_ref}
