"""LM micro-benchmarks: the counterpart of ``benchmarks/lm_bench.py``.

``arch_step_rows`` (the ``lm`` block of ``repro_torch.bench.run``): one
train step (loss and its gradients) and one decode step (its logits) of
each config reduced to 2 layers (``ModelConfig.reduce``), at B 2 x S 64,
through the port's own ``init_params``, ``init_caches``, ``loss_fn`` and
``decode_step`` (``step_bodies``).  On a CUDA card each is captured once as
a CUDA graph and its replays are timed, as the reference times its
``jax.jit`` of the same functions after the compile; on the CPU, which has
no graph, the bodies run eagerly.

``kernel_rows``: kernel call timings at the JAX benchmark's four shapes (BS
n=2^14, matmul 256x512x256, flash B=1 S=256 Hq=4 Hkv=2 Dh=64, FDTD3d
16x24x136), for the kernel (variant ``cuda``) and for its plain PyTorch
version (``torch_ref``).  On the CPU there is no kernel: the ``cuda`` rows
say so and carry no time.

    PYTHONPATH=src python -m repro_torch.bench.lm_bench [--device cpu]

On a CUDA card each row is timed with CUDA events after one warm-up call
(of the graph's replay for the ``lm`` rows); on the CPU with the host
clock.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.device import resolve
from repro_torch.kernels import black_scholes, fdtd3d_step, flash_attention, matmul
from repro_torch.launch.step import _graph_capture
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


def _graph_us(fn, dev: torch.device, reps: int = ARCH_REPS) -> tuple[float, float]:
    """fn() captured once as a CUDA graph: (mean microseconds a replay, the
    capture's seconds).  fn runs once eagerly on the capture stream (the
    warm-up, as the reference's first call compiles and runs), is captured
    on that stream, and the graph is timed by ``_time_us`` (one replay, then
    ``reps`` timed).  The graph and fn's outputs are released on return."""
    graph = torch.cuda.CUDAGraph()
    capture, stream = _graph_capture(graph)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    with capture:
        out = fn()
    torch.cuda.synchronize(dev)
    capture_s = time.perf_counter() - t0
    us = _time_us(graph.replay, dev, reps)
    del out, graph
    return us, capture_s


def step_bodies(params, batch: dict, step_in: dict, caches: dict, cfg):
    """(train, decode): the two computations the reference jits.  train()
    returns ``loss_fn`` and its gradients over the trainable weights
    (``torch.autograd.grad``), as ``jax.value_and_grad(loss_fn)``; decode()
    returns the logits of ``decode_step`` at position 3 (``cache_len`` a 0-d
    int32 on the caches' device), as the reference's ``decode_step(...)[0]``.
    decode writes the new row and recurrent states into ``caches`` in
    place."""
    weights = [p for p in params.parameters() if p.requires_grad]
    cache_len = torch.full((), 3, dtype=torch.int32,
                           device=next(iter(caches.values())).device)

    def train():
        loss = loss_fn(params, batch, cfg)
        return loss, torch.autograd.grad(loss, weights)

    def decode():
        with torch.no_grad():
            return decode_step(params, step_in, caches, cache_len, cfg)[0]

    return train, decode


def arch_step_rows(archs=ARCH_NAMES, device=None, capture_s: dict | None = None) -> list[str]:
    """CSV rows ``lm,<arch>,train_step|decode_step,<us>,reduced B2xS64``:
    the reduced config's train step and one decode step at position 3 of a
    64-position cache (``step_bodies``), each a CUDA graph's replay on a
    card (``_graph_us``) and an eager call on the CPU.  ``capture_s``, if
    given, receives each card row's capture seconds under (arch, op).  Each
    config's graphs are released before the next config is built."""
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
        train, decode = step_bodies(params, batch, step_in, init_caches(cfg, B, S, dev), cfg)
        for op, fn, derived in (("train_step", train, f"reduced B{B}xS{S}"),
                                ("decode_step", decode, f"reduced B{B}")):
            if dev.type == "cuda":
                us, secs = _graph_us(fn, dev)
                if capture_s is not None:
                    capture_s[(name, op)] = secs
            else:
                us = _time_us(fn, dev, ARCH_REPS)
            rows.append(f"lm,{name},{op},{us:.0f},{derived}")
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
