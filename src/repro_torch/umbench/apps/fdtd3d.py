"""FDTD3d — 3-D finite-difference time domain (paper Table I).

Reads/writes two equal arrays in an interleaving manner; both initialized
with the same data.  Advise (paper §IV-B): PREFERRED_LOCATION(DEVICE) +
ACCESSED_BY(HOST) on ONE array (PRE_INIT, so host initialization writes
remotely on coherent fabrics); nothing on the other; READ_MOSTLY only on
the small coefficient array.  Prefetch: only one of the two arrays (they
start identical) — the paper's 60.9 s -> 45.3 s observation.
``workload()`` builds the trace; variant lowering lives in
``umbench.variants``.

``numeric()`` computes it for real.
"""
from __future__ import annotations

import torch

from repro_torch.core.advise import Accessor, MemorySpace
from repro_torch.device import resolve
from repro_torch.kernels import fdtd3d_run
from repro_torch.kernels.fdtd3d.ref import fdtd3d_step_ref
from repro_torch.umbench.workload import PRE_INIT, Workload, WorkloadBuilder

NAME = "fdtd3d"
ITERS = 6
COEF_BYTES = 4 * 1024
COEFFS = (0.55, 0.1, 0.02, 0.008, 0.002)


def workload(total_bytes: float, iters: int = ITERS) -> Workload:
    nb = (int(total_bytes) - COEF_BYTES) // 2
    w = WorkloadBuilder(NAME)
    w.alloc("U0", nb, role="field")
    w.alloc("U1", nb, role="field")
    w.alloc("COEF", COEF_BYTES, role="constants")

    w.advise_preferred_location("U0", MemorySpace.DEVICE, when=PRE_INIT)
    w.advise_accessed_by("U0", Accessor.HOST, when=PRE_INIT)

    w.host_write("U0")
    w.host_write("U1")
    w.host_write("COEF")

    w.advise_read_mostly("COEF")
    w.prefetch("U0")   # only one array (paper §IV-B)

    cells = nb / 4
    for i in range(iters):
        src, dst = ("U0", "U1") if i % 2 == 0 else ("U1", "U0")
        w.kernel("stencil", flops=27.0 * cells,
                 reads=(src, "COEF"), writes=(dst,))
    w.readback("U1" if iters % 2 == 1 else "U0")
    return w.build()


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
