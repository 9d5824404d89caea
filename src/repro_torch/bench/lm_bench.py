"""LM micro-benchmarks: the counterpart of ``benchmarks/lm_bench.py``.

``arch_step_rows`` (the ``lm`` block of ``repro_torch.bench.run``): one
train step (loss and its gradients) and one decode step of each config
reduced to 2 layers (``ModelConfig.reduce``), at B 2 x S 64, through the
port's own ``init_params``, ``init_caches``, ``loss_fn`` and
``decode_step``.

``kernel_rows``: kernel call timings at the JAX benchmark's four shapes (BS
n=2^14, matmul 256x512x256, flash B=1 S=256 Hq=4 Hkv=2 Dh=64, FDTD3d
16x24x136), for the kernel (variant ``cuda``) and for its plain PyTorch
version (``torch_ref``).  On the CPU there is no kernel: the ``cuda`` rows
say so and carry no time.

    PYTHONPATH=src python -m repro_torch.bench.lm_bench [--device cpu]

On a CUDA card each row is timed with CUDA events after one warm-up call;
on the CPU with the host clock.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.device import resolve
from repro_torch.kernels import black_scholes, fdtd3d_step, flash_attention, matmul
from repro_torch.models import decode_step, init_caches, init_params, loss_fn

HEADER = "table,kernel,variant,us_per_call,derived"
ARCH_HEADER = "table,arch,op,us_per_call,derived"
REPS = 20  # calls timed per kernel row, after one warm-up call
ARCH_REPS = 5  # steps timed per arch row, as the JAX benchmark times them
ARCH_B, ARCH_S = 2, 64


def _time_us(fn, dev: torch.device, reps: int = REPS) -> float:
    """Mean microseconds per call of fn() after one warm-up call."""
    fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps * 1e3


def arch_step_rows(archs=ARCH_NAMES, device=None) -> list[str]:
    """CSV rows ``lm,<arch>,train_step|decode_step,<us>,reduced B2xS64``:
    the reduced config's train step (loss and its gradients) and one decode
    step at position 3 of a 64-position cache."""
    dev = resolve(device)
    B, S = ARCH_B, ARCH_S
    rows = [ARCH_HEADER]
    for name in archs:
        cfg = get_config(name).model.reduce()
        g = torch.Generator(device=dev).manual_seed(0)
        params = init_params(cfg, g, dev)
        if cfg.family == "audio":
            toks = torch.randint(0, cfg.vocab_size, (B, S, cfg.num_codebooks),
                                 generator=g, device=dev)
            batch = {"tokens": toks, "labels": toks}
            step_in = {"tokens": torch.zeros((B, cfg.num_codebooks), dtype=torch.long,
                                             device=dev)}
        elif cfg.family == "vlm":
            batch = {"embeds": torch.randn((B, S, cfg.d_model), generator=g, device=dev),
                     "labels": torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                                             device=dev)}
            step_in = {"tokens": torch.zeros((B,), dtype=torch.long, device=dev)}
        else:
            toks = torch.randint(0, cfg.vocab_size, (B, S), generator=g, device=dev)
            batch = {"tokens": toks, "labels": toks}
            step_in = {"tokens": torch.zeros((B,), dtype=torch.long, device=dev)}
        weights = [p for p in params.parameters() if p.requires_grad]

        def train():
            loss = loss_fn(params, batch, cfg)
            torch.autograd.grad(loss, weights)

        us = _time_us(train, dev, ARCH_REPS)
        rows.append(f"lm,{name},train_step,{us:.0f},reduced B{B}xS{S}")
        caches = init_caches(cfg, B, S, dev)

        def decode():
            with torch.no_grad():
                decode_step(params, step_in, caches, 3, cfg)

        us = _time_us(decode, dev, ARCH_REPS)
        rows.append(f"lm,{name},decode_step,{us:.0f},reduced B{B}")
    return rows


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
