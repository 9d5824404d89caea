"""CG — conjugate-gradient sparse solver (paper Table I).

Advise policy (paper §IV-A): PREFERRED_LOCATION(DEVICE) on the matrix and b
(+ ACCESSED_BY(HOST) so host initialization writes remotely into device
memory on coherent platforms — the P9 in-memory win), READ_MOSTLY on the
sparse matrix after initialization.  The error is computed on the host after
the solve (one host read, in *every* variant).  The placement advises are
PRE_INIT hints — they must land before host initialization for the remote
init path to engage.  ``workload()`` builds the trace; variant lowering
lives in ``umbench.variants``.

``numeric()`` computes it for real in plain PyTorch, as the JAX side
computes it in plain ``jnp``.
"""
from __future__ import annotations

import torch

from repro_torch.core.advise import Accessor, MemorySpace
from repro_torch.device import resolve
from repro_torch.umbench.workload import PRE_INIT, Workload, WorkloadBuilder

NAME = "cg"
ITERS = 12


def workload(total_bytes: float, iters: int = ITERS) -> Workload:
    a_data = int(total_bytes * 0.55)
    a_idx = int(total_bytes * 0.25)
    vec = int(total_bytes * 0.05)
    w = WorkloadBuilder(NAME)
    w.alloc("A_data", a_data, role="matrix")
    w.alloc("A_idx", a_idx, role="matrix")
    for nm in ("x", "b", "p", "q"):
        w.alloc(nm, vec, role="vector")

    for nm in ("A_data", "A_idx", "b"):
        w.advise_preferred_location(nm, MemorySpace.DEVICE, when=PRE_INIT)
        w.advise_accessed_by(nm, Accessor.HOST, when=PRE_INIT)

    for nm in ("A_data", "A_idx", "b", "x", "p"):
        w.host_write(nm)

    w.advise_read_mostly("A_data")
    w.advise_read_mostly("A_idx")
    w.prefetch("A_data", "A_idx", "b", "p")

    nnz = a_data / 4
    for _ in range(iters):
        # SpMV: q = A p
        w.kernel("spmv", flops=2.0 * nnz,
                 reads=("A_data", "A_idx", "p"), writes=("q",))
        # dots + axpys on vectors
        w.kernel("blas1", flops=6.0 * (vec / 4),
                 reads=("q", "p", "b"), writes=("x", "p"))
    w.host_read("x")
    return w.build()


def laplacian_csr(n: int, device=None):
    """1-D Laplacian (SPD, tridiagonal) in CSR: (data, idx, ptr)."""
    data, idx, ptr = [], [], [0]
    for i in range(n):
        cols, vals = [], []
        if i > 0:
            cols.append(i - 1)
            vals.append(-1.0)
        cols.append(i)
        vals.append(2.0)
        if i < n - 1:
            cols.append(i + 1)
            vals.append(-1.0)
        data += vals
        idx += cols
        ptr.append(len(idx))
    dev = resolve(device)
    return (torch.tensor(data, dtype=torch.float32, device=dev),
            torch.tensor(idx, dtype=torch.int64, device=dev),
            torch.tensor(ptr, dtype=torch.int64, device=dev))


def csr_matvec(data, idx, ptr, x):
    """CSR SpMV as a segment sum over rows (``index_add_``)."""
    n = ptr.shape[0] - 1
    rows = torch.repeat_interleave(torch.arange(n, device=x.device),
                                   torch.diff(ptr), output_size=data.shape[0])
    return torch.zeros(n, dtype=x.dtype, device=x.device).index_add_(
        0, rows, data * x[idx])


def cg_solve(data, idx, ptr, b, iters: int = 200):
    """``iters`` CG iterations from x = 0; returns (x, |r|^2)."""
    x = torch.zeros_like(b)
    r = b - csr_matvec(data, idx, ptr, x)
    p = r
    rs = torch.dot(r, r)
    for _ in range(iters):
        ap = csr_matvec(data, idx, ptr, p)
        alpha = rs / torch.clamp_min(torch.dot(p, ap), 1e-30)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = torch.dot(r, r)
        p = r + (rs_new / torch.clamp_min(rs, 1e-30)) * p
        rs = rs_new
    return x, rs


def numeric(seed: int = 0, n: int = 256, device=None):
    """Solve L x = b for the n x n 1-D Laplacian and an N(0, 1) b, with 2n
    iterations."""
    dev = resolve(device)
    data, idx, ptr = laplacian_csr(n, dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    b = torch.randn(n, generator=g, device=dev)
    x, res = cg_solve(data, idx, ptr, b, iters=2 * n)
    return {"x": x, "residual": res, "b": b,
            "Ax": csr_matvec(data, idx, ptr, x)}
