#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA card

1. Builds the port's CUDA kernels from this checkout's sources and prints
   the card, its power limit, the toolchain and the build time.
2. Holds each kernel against its plain PyTorch version on the card at the
   shapes of the repository's kernel tests.
3. Drives the paper's suite through the port's ``numeric()`` entry points at
   the paper's in-memory working set, 0.8 x 16 GiB (the ``in_memory`` regime
   on the 16 GiB Volta of ``intel-volta-pcie``): BS over 687,194,767
   options, a 33,842^2 fp32 SGEMM and a 1192 x 1200 x 1200 FDTD3d grid for 3
   steps, one app at a time.  Each kernel's launch counter is set to 0 just
   before its app runs and read just after; its output is held against the
   plain version at the JAX tests' tolerance; then the kernel, the plain
   version and, where one PyTorch call computes the same function, that call
   are timed with CUDA events (one warm-up, median of 3) beside the kernel's
   bound from the H100's published peaks.
4. Runs CG, Graph500 and the FFT convolutions at their default sizes.

Prints a ``{"kernels": [...]}`` line, then as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Exits non-zero, with no such line, if a check fails, or if there is no CUDA
card or no port beside this script.
"""
from __future__ import annotations

import gc
import json
import math
import statistics
import subprocess
import sys
import time
from collections import deque
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

GB = 2**30
# harness.run_cell's working set for intel-volta-pcie in the in_memory regime
WORKING_SET = int(0.8 * 16 * GB)
BS_N = WORKING_SET // 5 // 4                          # bs.workload: nb = total // 5
GEMM_N = int(math.sqrt(WORKING_SET // 3 / 4))         # cublas.workload
GEMM_N_REDUCED = 16384
GEMM_MAX_S = 60.0
FDTD_SHAPE = (1192, 1200, 1200)                       # fits (total - 4096) // 2 bytes, Z % 8 == 0
FDTD_STEPS = 3
DEVICE = "cuda"

# Published H100 SXM peaks (NVIDIA data sheet) at its 700 W limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12     # outside the tensor cores
BS_OPS_PER_OPTION = 60      # the BS app's model (FLOPS_PER_ELEM)
FDTD_OPS_PER_CELL = 29      # c0*x, then 4 x (5 adds, 1 mul, 1 add)

SOURCES = {
    "black_scholes": ("src/repro_torch/kernels/csrc/black_scholes.cu",
                      "src/repro/kernels/black_scholes/kernel.py:20"),
    "matmul": ("src/repro_torch/kernels/csrc/streamed_matmul.cu",
               "src/repro/kernels/streamed_matmul/kernel.py:17"),
    "fdtd3d": ("src/repro_torch/kernels/csrc/fdtd3d.cu",
               "src/repro/kernels/fdtd3d/kernel.py:24"),
}


class Smoke:
    """Runs the phases and keeps what they found."""

    def __init__(self, torch, kernels, apps):
        self.torch = torch
        self.kernels = kernels
        self.apps = apps
        self.counters = {"black_scholes": kernels.black_scholes,
                         "matmul": kernels.matmul,
                         "fdtd3d": kernels.fdtd3d_step}
        self.failures: list[str] = []
        self.rows: list[dict] = []
        self.power_limit = "unknown"

    # -- helpers ---------------------------------------------------------

    def check(self, label, got, want, atol, rtol=0.0) -> float:
        """Record whether |got - want| <= atol + rtol*|want| everywhere and
        every value is finite; return the largest |got - want|."""
        torch = self.torch
        err = got.float() - want.float()
        err.abs_()
        max_err = err.max().item() if err.numel() else 0.0
        limit = want.float().abs().mul_(rtol).add_(atol)
        bad = int((err > limit).sum().item())
        finite = bool(torch.isfinite(got).all().item())
        ok = bad == 0 and finite and got.shape == want.shape
        print(f"check {label}: max_abs_err={max_err:.3e} atol={atol:.3e} "
              f"rtol={rtol:g} {'ok' if ok else f'FAIL ({bad} out of tolerance, finite={finite})'}")
        if not ok:
            self.failures.append(label)
        return max_err

    def expect(self, label, cond: bool):
        print(f"check {label}: {'ok' if cond else 'FAIL'}")
        if not cond:
            self.failures.append(label)

    def expect_raise(self, label, fn, exc):
        try:
            fn()
        except exc as e:
            print(f"check {label}: raised {type(e).__name__} ok")
            return
        self.failures.append(label)
        print(f"check {label}: FAIL (did not raise {exc.__name__})")

    def time_ms(self, fn, reps: int = 3) -> float:
        """Median of ``reps`` CUDA-event timings of fn(), after a warm-up."""
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def reset_counts(self):
        for fn in self.counters.values():
            fn.launches = 0

    def free(self):
        gc.collect()
        self.torch.cuda.synchronize()
        self.torch.cuda.empty_cache()

    def rand(self, shape, lo=None, hi=None, dtype=None):
        torch = self.torch
        if lo is None:
            t = torch.randn(*shape, device=DEVICE)
        else:
            t = torch.empty(*shape, device=DEVICE).uniform_(lo, hi)
        return t if dtype is None else t.to(dtype)

    @staticmethod
    def bound(nbytes: float, ops: float) -> tuple[float, str]:
        by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        by_ops = ops / PEAK_FP32_FLOPS * 1e3
        return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")

    def record(self, name, *, launches, max_err, ms, plain_ms, library_ms,
               nbytes, ops, shape, tol):
        bound_ms, bound_by = self.bound(nbytes, ops)
        peak = self.torch.cuda.max_memory_allocated()
        share = bound_ms / ms
        source, replaces = SOURCES[name]
        lib = "null" if library_ms is None else f"{library_ms:.3f}"
        print(f"kernel {name} {shape}: kernel_ms={ms:.3f} plain_ms={plain_ms:.3f} "
              f"library_ms={lib} bound_ms={bound_ms:.3f} ({bound_by}; published "
              f"H100 SXM peaks at 700 W, this card's limit {self.power_limit}) "
              f"share_of_bound={share:.3f} max_memory_allocated={peak} "
              f"launches={launches}")
        self.rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": max_err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms, "share": share,
            "shape": list(shape), "tolerance": tol,
            "max_memory_allocated": peak})

    def start_app(self, label):
        print(f"== main path: {label}")
        self.free()
        self.torch.cuda.reset_peak_memory_stats()
        self.reset_counts()

    def launched(self, name) -> int:
        n = self.counters[name].launches
        self.expect(f"{name} kernel launched on the main path ({n} launches)", n > 0)
        return n

    # -- phases ----------------------------------------------------------

    def header(self):
        torch = self.torch
        from repro_torch.kernels import _build

        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout.strip()
        print(smi)
        self.power_limit = smi.splitlines()[0].split(",")[-1].strip()
        nvcc = subprocess.run([_build.nvcc(), "--version"], capture_output=True,
                              text=True, timeout=60, check=True).stdout
        print(f"torch {torch.__version__} cuda {torch.version.cuda} "
              f"device {torch.cuda.get_device_name(0)}")
        print(f"nvcc: {nvcc.strip().splitlines()[-2]}")
        t0 = time.perf_counter()
        _build.library()
        print(f"kernel build: {time.perf_counter() - t0:.1f} s -> "
              f"{_build.library_path().relative_to(ROOT)}")
        log = _build.library_path().with_suffix(".log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "Compiling entry" in line or "Used" in line or "spill" in line:
                    print(f"  ptxas: {line.split('ptxas info    :')[-1].strip()}")

    def kernel_checks(self):
        """Each kernel against its plain version at the kernel tests' shapes."""
        torch, k = self.torch, self.kernels
        print("== kernel checks at test shapes")
        for n in (7, 128, 1001, 4096):
            s, x, t = self.rand((n,), 5, 30), self.rand((n,), 1, 100), self.rand((n,), 0.25, 10)
            c, p = k.black_scholes(s, x, t)
            cr, pr = k.black_scholes(s, x, t, use_kernel=False)
            self.check(f"black_scholes n={n} call", c, cr, 1e-4)
            self.check(f"black_scholes n={n} put", p, pr, 1e-4)
        s, x, t = (self.rand((4097,), lo, hi)[1:] for lo, hi in ((5, 30), (1, 100), (0.25, 10)))
        c, p = k.black_scholes(s, x, t)
        cr, pr = k.black_scholes(s, x, t, use_kernel=False)
        self.check("black_scholes n=4096 unaligned call", c, cr, 1e-4)
        self.check("black_scholes n=4096 unaligned put", p, pr, 1e-4)
        self.expect_raise("black_scholes rejects a strided view",
                          lambda: k.black_scholes(s[::2], x[::2], t[::2]), ValueError)
        self.expect_raise("black_scholes rejects fp64",
                          lambda: k.black_scholes(s.double(), x.double(), t.double()),
                          TypeError)

        for m, kk, n in ((8, 16, 8), (300, 700, 250), (256, 512, 128)):
            for dtype, atol in ((torch.float32, 1e-3), (torch.bfloat16, 0.15)):
                a, b = self.rand((m, kk), dtype=dtype), self.rand((kk, n), dtype=dtype)
                self.check(f"matmul {m}x{kk}x{n} {dtype}", k.matmul(a, b),
                           k.matmul(a, b, use_kernel=False), atol * math.sqrt(kk), 1e-2)
        self.expect_raise("matmul rejects a transposed view",
                          lambda: k.matmul(a.t(), a), ValueError)

        coef = torch.tensor([0.5, 0.1, 0.05, 0.02, 0.01], device=DEVICE)
        for shape in ((8, 16, 128), (16, 24, 136), (24, 8, 256), (5, 3, 40)):
            g = self.rand(shape)
            self.check(f"fdtd3d_step {shape}", k.fdtd3d_step(g, coef),
                       k.fdtd3d_step(g, coef, use_kernel=False), 1e-4)
        g = self.rand((16, 24, 136))
        before = g.clone()
        self.check("fdtd3d_run (16, 24, 136) steps=2", k.fdtd3d_run(g, coef, steps=2),
                   k.fdtd3d_run(g, coef, steps=2, use_kernel=False), 1e-3)
        self.expect("fdtd3d_run leaves its input as it was", bool(torch.equal(g, before)))
        coef = torch.tensor([0.4, 0.05, 0.03, 0.015, 0.005], device=DEVICE)
        out = k.fdtd3d_step(torch.full((8, 16, 128), 2.5, device=DEVICE), coef)
        factor = float(coef[0] + 6 * coef[1:].sum())
        self.check("fdtd3d constant field", out, torch.full_like(out, 2.5 * factor),
                   0.0, 1e-5)
        torch.cuda.synchronize()

    def gemm_size(self) -> int:
        """The paper's GEMM size, or the reduced one if the kernel would take
        longer than GEMM_MAX_S there (projected from n = 4096 by n^3)."""
        a, b = self.rand((4096, 4096)), self.rand((4096, 4096))
        ms = self.time_ms(lambda: self.kernels.matmul(a, b))
        projected = ms / 1e3 * (GEMM_N / 4096) ** 3
        print(f"matmul probe n=4096: {ms:.3f} ms -> projected {projected:.1f} s at n={GEMM_N}")
        if projected > GEMM_MAX_S:
            print(f"REDUCED: matmul runs at n={GEMM_N_REDUCED} instead of {GEMM_N} "
                  f"(projected {projected:.1f} s > {GEMM_MAX_S:.0f} s)")
            return GEMM_N_REDUCED
        return GEMM_N

    def main_path(self):
        torch, k, apps = self.torch, self.kernels, self.apps
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")

        self.start_app(f"bs n={BS_N}")
        out = apps["bs"].numeric(n=BS_N, device=DEVICE)
        torch.cuda.synchronize()
        launches = self.launched("black_scholes")
        err = max(self.check("bs call (paper size)", out["call"], out["call_ref"], 1e-4),
                  self.check("bs put (paper size)", out["put"], out["put_ref"], 1e-4))
        s, x, t = out["s"], out["x"], out["t"]
        del out
        self.free()
        ms = self.time_ms(lambda: k.black_scholes(s, x, t))
        plain = self.time_ms(lambda: k.black_scholes(s, x, t, use_kernel=False))
        self.record("black_scholes", launches=launches, max_err=err, ms=ms,
                    plain_ms=plain, library_ms=None, nbytes=20 * BS_N,
                    ops=BS_OPS_PER_OPTION * BS_N, shape=(BS_N,), tol=1e-4)
        del s, x, t

        n = self.gemm_size()
        self.start_app(f"cublas n={n}")
        out = apps["cublas"].numeric(n=n, device=DEVICE)
        torch.cuda.synchronize()
        launches = self.launched("matmul")
        atol = 1e-3 * math.sqrt(n)
        err = self.check("cublas c (paper size)", out["c"], out["c_ref"], atol, 1e-2)
        a, b = out["a"], out["b"]
        del out
        self.free()
        ms = self.time_ms(lambda: k.matmul(a, b))
        plain = self.time_ms(lambda: k.matmul(a, b, use_kernel=False))
        library = self.time_ms(lambda: torch.matmul(a, b))
        self.record("matmul", launches=launches, max_err=err, ms=ms,
                    plain_ms=plain, library_ms=library, nbytes=3 * 4 * n * n,
                    ops=2 * n**3, shape=(n, n, n), tol=[atol, 1e-2])
        del a, b

        self.start_app(f"fdtd3d {FDTD_SHAPE} x {FDTD_STEPS} steps")
        out = apps["fdtd3d"].numeric(shape=FDTD_SHAPE, steps=FDTD_STEPS,
                                      device=DEVICE)
        torch.cuda.synchronize()
        launches = self.launched("fdtd3d")
        err = self.check("fdtd3d out (paper size)", out["out"], out["ref"], 1e-3)
        grid, coeffs = out["grid"], out["coeffs"]
        del out
        self.free()
        cells = math.prod(FDTD_SHAPE)
        ms = self.time_ms(lambda: k.fdtd3d_step(grid, coeffs))
        plain = self.time_ms(lambda: k.fdtd3d_step(grid, coeffs, use_kernel=False))
        self.record("fdtd3d", launches=launches, max_err=err, ms=ms,
                    plain_ms=plain, library_ms=None, nbytes=8 * cells + 4 * 5,
                    ops=FDTD_OPS_PER_CELL * cells, shape=FDTD_SHAPE, tol=1e-3)
        del grid, coeffs
        self.free()

    def plain_apps(self):
        """CG, Graph500 and the FFT convolutions at their default sizes."""
        apps = self.apps
        print("== plain apps at default sizes")
        # tests/test_umbench_numeric.py holds A x to b at n=128: at the
        # default n=256, |x| reaches ~1e4 and fp32 rounding of A x alone
        # comes near 1e-3
        for n in (256, 128):
            out = apps["cg"].numeric(n=n, device=DEVICE)
            res = float(out["residual"])
            self.expect(f"cg n={n} residual {res:.3e} < 1e-6", res < 1e-6)
        self.check("cg n=128 A x == b", out["Ax"], out["b"], 1e-3)

        out = apps["graph500"].numeric(device=DEVICE)
        n = out["n"]
        adj = [[] for _ in range(n)]
        for u, v in out["edges"]:
            adj[u].append(v)
            adj[v].append(u)
        expect = [-1] * n
        expect[0] = 0
        queue = deque([0])
        while queue:
            u = queue.popleft()
            for v in adj[u]:
                if expect[v] < 0:
                    expect[v] = expect[u] + 1
                    queue.append(v)
        self.expect("graph500 levels == breadth-first search",
                    out["level"].cpu().tolist() == expect)

        for real in (True, False):
            out = apps["conv"].numeric(real=real, device=DEVICE)
            self.check(f"conv {'real' if real else 'complex'} FFT == direct",
                       out["out"], out["ref"], 1e-3)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        from repro_torch import kernels
        from repro_torch.umbench.apps import (bfs, black_scholes, cg, conv_fft,
                                              fdtd3d, matmul)
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}", file=sys.stderr)
        return 2

    apps = {"bs": black_scholes, "cublas": matmul, "fdtd3d": fdtd3d,
            "cg": cg, "graph500": bfs, "conv": conv_fft}
    smoke = Smoke(torch, kernels, apps)
    t0 = time.perf_counter()
    smoke.header()
    smoke.kernel_checks()
    smoke.main_path()
    smoke.plain_apps()
    print(json.dumps({"kernels": smoke.rows}))
    print(f"chip_smoke: {time.perf_counter() - t0:.1f} s")
    if smoke.failures:
        print(f"chip_smoke: {len(smoke.failures)} checks failed: {smoke.failures}",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
