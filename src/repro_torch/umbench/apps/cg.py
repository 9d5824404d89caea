"""CG: conjugate-gradient sparse solver (paper Table I), computed for real
in plain PyTorch, as the JAX side computes it in plain ``jnp``."""
from __future__ import annotations

import torch

from repro_torch.device import resolve

NAME = "cg"


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
