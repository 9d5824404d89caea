"""Kernel call timings: the counterpart of ``kernel_rows`` in
``benchmarks/lm_bench.py``, at the same four shapes (BS n=2^14, matmul
256x512x256, flash B=1 S=256 Hq=4 Hkv=2 Dh=64, FDTD3d 16x24x136).

    PYTHONPATH=src python -m repro_torch.bench.lm_bench [--device cpu]

On a CUDA card each row is timed with CUDA events, for the kernel
(variant ``cuda``) and for its plain PyTorch version (``torch_ref``).  On
the CPU there is no kernel: the ``cuda`` rows say so and carry no time,
and the plain versions are timed with the host clock.  ``arch_step_rows``
is not ported yet.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.device import resolve
from repro_torch.kernels import black_scholes, fdtd3d_step, flash_attention, matmul

HEADER = "table,kernel,variant,us_per_call,derived"
REPS = 20  # calls timed per row, after one warm-up call


def _time_us(fn, dev: torch.device) -> float:
    """Mean microseconds per call of fn() after one warm-up call."""
    fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(REPS):
            fn()
        return (time.perf_counter() - t0) / REPS * 1e6
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / REPS * 1e3


def kernel_rows(device=None) -> list[str]:
    """CSV rows ``table,kernel,variant,us_per_call,derived`` for the four
    kernels of the JAX benchmark's kernel block."""
    dev = resolve(device)
    g = torch.Generator(device=dev).manual_seed(0)

    def uniform(shape, lo, hi):
        return torch.empty(shape, device=dev).uniform_(lo, hi, generator=g)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    n = 1 << 14
    s, x, t = uniform(n, 5, 30), uniform(n, 1, 100), uniform(n, 0.5, 5)
    a, b = randn(256, 512), randn(512, 256)
    q, k, v = randn(1, 256, 4, 64), randn(1, 256, 2, 64), randn(1, 256, 2, 64)
    grid = randn(16, 24, 136)
    coef = torch.tensor([0.5, 0.1, 0.05, 0.02, 0.01], device=dev)
    cases = (
        ("black_scholes", f"n={n}",
         lambda use: black_scholes(s, x, t, use_kernel=use)),
        ("streamed_matmul", "256x512x256", lambda use: matmul(a, b, use_kernel=use)),
        ("flash_attention", "S=256",
         lambda use: flash_attention(q, k, v, use_kernel=use)),
        ("fdtd3d", "16x24x136", lambda use: fdtd3d_step(grid, coef, use_kernel=use)),
    )
    rows = [HEADER]
    for name, derived, fn in cases:
        if dev.type == "cuda":
            us = _time_us(lambda: fn(True), dev)
            rows.append(f"kernel,{name},cuda,{us:.1f},{derived}")
        else:
            rows.append(f"kernel,{name},cuda,,skipped: no CUDA kernel on {dev.type}")
        us = _time_us(lambda: fn(False), dev)
        rows.append(f"kernel,{name},torch_ref,{us:.1f},{derived}")
    return rows


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="kernel call timings")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    print("\n".join(kernel_rows(parser.parse_args(argv).device)))


if __name__ == "__main__":
    main()
