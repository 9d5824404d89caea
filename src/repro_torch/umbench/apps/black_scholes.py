"""BS — Black-Scholes option pricing (paper Table I).

Good data reuse: the same input set is priced over multiple iterations.
Advise policy (paper §IV-A): READ_MOSTLY on the three input arrays after
initialization; nothing else.  Prefetch: the input arrays.

``workload()`` builds the declarative trace; variant lowering lives in
``umbench.variants`` (the app has zero variant logic).

``numeric()`` computes it for real.
"""
from __future__ import annotations

import torch

from repro_torch.device import resolve
from repro_torch.kernels import black_scholes as bs_kernel
from repro_torch.kernels.black_scholes.ref import black_scholes_ref
from repro_torch.umbench.workload import Workload, WorkloadBuilder

NAME = "bs"
ITERS = 8
FLOPS_PER_ELEM = 60.0
ELEM_BYTES = 4

INPUTS = ("S", "X", "T")
OUTPUTS = ("CALL", "PUT")


def workload(total_bytes: float, iters: int = ITERS) -> Workload:
    nb = int(total_bytes) // 5
    w = WorkloadBuilder(NAME)
    for nm in INPUTS + OUTPUTS:
        w.alloc(nm, nb, role="input" if nm in INPUTS else "output")
    for nm in INPUTS:
        w.host_write(nm)
        w.advise_read_mostly(nm)
        w.prefetch(nm)

    elems = nb / ELEM_BYTES
    for _ in range(iters):
        w.kernel("bs", flops=FLOPS_PER_ELEM * elems,
                 reads=INPUTS, writes=OUTPUTS)
    for nm in OUTPUTS:
        w.readback(nm)
    return w.build()


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
