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
   plain version at the JAX tests' tolerance; the SGEMM, whose fp32 kernel
   runs 3xTF32 on the tensor cores, is also held against fp64 on 256 rows at
   4 times the error of ``torch.matmul`` in fp32, a limit that a one-pass
   TF32 product is shown to fail.  Then the kernel, the plain version and,
   where one PyTorch call computes the same function, that call
   (``torch.matmul``; for FDTD3d a replicate-padded ``nn.Conv3d`` with the
   25-tap star as its weight) are timed with CUDA events (one warm-up,
   median of 3) beside the kernel's bound from the H100's published peaks.
4. Holds the flash and paged attention kernels against their plain
   versions at the shapes of the repository's kernel tests, then drives the
   attention paths at full width, each kernel's launch counter set to 0
   just before its path and read just after: the paged-decode demo's
   ``paged_decode`` at qwen2-72b / decode_32k (B=128, 512 pages of 64 a
   sequence, a 17.2 GB bf16 pool), the paged kernel again over a randomly
   permuted block table with random lengths and over lengths at the edges
   of its stages and split-KV chunks (short rows among them), twice on the
   same inputs for the same bits, and bf16 flash prefill at S=32,768 for
   qwen2-7b (causal) and mixtral-8x22b (window 4096).  The
   paged output is held against the plain version in groups of 8
   sequences, the flash output against the port's blocked
   ``attention_flash`` (the dense reference would need a 120 GB score
   tensor), both run in fp32 on the same values, and each limit is shown
   to catch a one-tile fault: a sequence one page short, the causal
   diagonal a tile left, the window a tile short, a wrong V tile.  Times
   as in 3; for flash the library time is the fastest fused backend of
   ``scaled_dot_product_attention`` that takes the case, which the port
   never calls.
5. Serves qwen2-7b at full width and depth in bf16 through
   ``repro_torch.launch.serve.serve`` (B 8, 2,048-token prompts from
   ``data.pipeline.prefetched``, 32 generated tokens): prefill ms, decode
   ms a token, tokens/s, peak memory and each phase's share of its bound.
   serve decodes through ``launch.step.build_serve_step``, one captured
   CUDA graph a token: its tokens and logits are held bit for bit against
   eager ``decode_step``s run on a copy of the same post-prefill caches
   with the same inputs (ms a token both ways, the capture's ms), a replay
   with a stale input (cache_len left un-advanced; for rwkv, whose step
   reads no cache_len, the state left at the prompt's) is shown to fail
   that comparison, and the graph must refuse other caches.  serve
   prefills through ``launch.step.build_prefill_step``, one layer's CUDA
   graph captured once and replayed over the layers: the cold call's logits
   and a warm call's logits and every cache tensor are held bit for bit
   against the eager ``transformer.prefill`` on the same prompt batch (cold
   ms with the capture, the capture's ms, warm and eager ms, the memory
   each took and the slot's bytes), a warm call with one layer's weights
   left out of the slot is shown to fail that comparison, a prompt a token
   shorter must be refused, and a warm call under ``torch.profiler`` must
   launch one graph a layer (its host launch calls and busy share).  Then
   one prefill, 4 eager decode steps and 4 graph replays of the same shapes
   under ``torch.profiler``, for the device's busy share and the host's
   launch calls a token.  The decode attention of a bf16 model on the card
   reads the cache in place through the paged kernel: at the benchmark's
   two serve shapes (B 16 × 1,024 + 256, a cache of 1,280 positions, and
   B 8 × 2,048 + 8, one of 2,056; full depth) the first and last layers'
   route on the post-prefill cache is held against the fp64 plain
   attention at the paged kernel's full-width limit (which a dropped newest
   token and another sequence's pages fail), and the serve step captured
   on that route against one captured on the plain route (repeat_kv +
   einsum) on copies of the same caches fed the same tokens (logits at the
   bf16 limit below, next tokens alike, the counters and kernel launches of
   each), and bit for bit against its own eager steps, with ms a token
   both ways and the paged kernels' device time a layer beside the live
   K/V's bytes.  Then holds that model
   on the card: bf16 against the same weights in
   fp32 (relative L2 of the last logits, a limit shown to reject a zeroed
   ``wo`` and RoPE positions off by one), and fp32 prefill + decode
   against the full forward at the JAX test's 2e-2.  The other families
   are served and held the same way at full width: rwkv6-3b and
   hymba-1.5b at 16 of 32 layers, mixtral-8x22b at 8 of its 56 (with the
   share of (token, choice) pairs its MoE drops in prefill and decode,
   counted in a serve with eager steps); each one's decode steps (eager
   and graph), its graph prefill and a 1-layer copy's eager prefill are
   profiled.  They are held on the
   card as qwen2-7b is: bf16 against fp32 (the fp32 run routed as the bf16
   run; rwkv6-3b at its own limit, twice the reference's gap) with one
   fault each (rwkv's token shift ignored, hymba's Mamba D skip dropped,
   MoE gates not renormalised); rwkv and hymba fp32 prefill + decode
   against the full forward; one full-width mixtral MoE layer in fp32
   against a per-token loop.
6. Measures the movement layer: host<->device copy rates, the
   ``PrefetchIterator`` at depths 0/1/2 beside a device workload of about
   the batch's copy time (every batch held bit for bit), ``fetch_params`` /
   ``offload_params`` of one full-width layer, and the four remat
   policies on a 2-layer full-width model ("offload", which recomputes as
   the reference's does, bit for bit "full" with "full"'s peak).  With two
   cards, launches each kernel on device 1 after device 0.
7. The UM simulator and the paper's sweep engine (``repro_torch.core.
   simulator``, ``repro_torch.umbench``), NumPy on the card's host: the
   1,152-cell extended matrix run serially from the main thread (no cell in
   error, N/A exactly where the platform gates put it, the paper's five
   findings on its seed cells at tests/test_paper_claims.py's thresholds),
   the eight apps x the extended variants and regimes on ``h100-host``, the
   card's measured constants (memory, pinned host->device rate, device copy
   rate, the SGEMM's fp32 rate) beside that platform's data-sheet ones with
   the in-memory cells rerun on them, the simulated compute time of one BS,
   SGEMM and FDTD3d iteration beside the kernel's measured time, and the
   quickstart (its Black-Scholes on the card, held against the plain
   version), the advise tour and section 4 of the oversubscription demo.
   Then the serving sweep, the analysis CLI and the benchmark runner
   (``sweep_path``), on the card's host but for the last item: 24 clean
   serving cells (every variant, traffic pattern, KV regime and both
   serving platforms), each equal to its row of the committed
   ``BENCH_umbench.json`` (the JAX package's artifact, read as data); the
   12 variants serving the poisson trace at kv_150 on ``h100-host`` (no
   error cell, N/A exactly at the platform gate; goodput and ttft_p99);
   ``python -m repro_torch.umbench.analysis --contracts --serving``
   in-process (exit 0); the KV-serving demo; ``repro_torch.bench.run
   --fast --json`` into a temporary directory (the five claims met, every
   cell equal to the committed artifact's, that artifact's hash unchanged);
   and ``arch_step_rows`` on the card for the ten reduced configs, each
   train and decode step captured as a CUDA graph and its replays timed
   (the captures' seconds printed apart).
8. Trains starcoder2-3b at full width and depth (30 layers, 3.03 B
   parameters, bf16, fp32 masters; B 8 x S 2,048): 8 steps through
   ``repro_torch.launch.train.train`` with the optimizer state on the card,
   which trains through ``launch.step.build_train_step``'s compiled step
   (the whole step, optimizer included, one CUDA graph replayed a step):
   ms a step, tokens/s, peak memory, the capture's ms, one warm graph step
   under ``torch.profiler`` (at most 5 host launch calls), then the
   optimizer timed apart and one eager step timed and profiled; 4 graph
   steps against 4 eager steps (the step's body) from the same seed, one
   run after the other (the params bit for bit, every state tensor's
   digest alike); then 4 steps under a plan with int8 moments and the
   state in pinned host memory, which the step updates in place (fetch and
   offload ms, pinned bytes, the pinned allocator flat after step 0, peak
   memory), each beside its bound.  Checks: the same step-0 loss in both
   runs, finite losses; on a 2-layer cut at full width, the graph step bit
   for bit equal to the eager one with the state on the card and on the
   host, fp32 and int8 moments, and under the planner's last escalation
   (int8 moments on the host, remat "offload": bit for bit the same plan
   under "full", at most 5 host launch calls a warm step, the pinned
   allocator flat after step 0), a replay with the step buffer left
   unfilled shown to fail that comparison, other params refused, the
   optimizer on the host bit for bit equal to the card's, bf16 against
   fp32 at twice the reference's own gap, and ``apply_updates`` against
   itself in fp64 on the CPU, shown to reject a dropped bias correction;
   on the reduced configs, the loss falling over 30 steps, a restart from
   a checkpoint ending near an uninterrupted run (both through the graph
   step), and a bf16 + fp32 + int8 checkpoint round trip bit for bit.
9. The mesh path (``repro_torch.launch.mesh``, ``sharding``, ``step`` on a
   mesh, ``runtime.compression``, ``launch.dryrun``): on the 2-layer cut of
   8, one step in each sharding mode (2d, fsdp, zero1) on a (1, 1) mesh
   over NCCL, parameters and state as DTensors, held against the unsharded
   step (the loss and every updated parameter within 1e-6 of each tensor's
   largest value; whether they are bit for bit is printed), with each
   step's ms and its counted collectives; the int8 compressed all-reduce
   over the world-1 group bit for bit against quantize + dequantize; with
   two or more cards a 2d step on a (1, n) mesh, whose sharded products
   round in another order: the loss within the bf16 gap of 8's checks,
   each parameter within one Adam step (2 lr) and a bf16 ulp of the
   unsharded step's, at most 1 % of them off, and the compressed mean
   within one quantisation step of the plain mean.  The dry-run runs in a
   subprocess on the fake backend, beside the card's phases: starcoder2-3b
   / train_4k on the reference's 16 x 16 mesh (a roofline estimate for 256
   H100s, not a measurement), then the cut on a 1 x 1 mesh, whose traced
   peak must lie within 10 % of the 2d step's measured peak and whose
   traced FLOPs must reach the analytic count, and the full depth, printed
   beside 8's measured peak.
10. Runs CG, Graph500 and the FFT convolutions at their default sizes, and
    the kernel timing rows of ``repro_torch.bench.lm_bench``.

Prints ``{"serve_path": ...}``, ``{"decode_route": ...}``, ``{"family_serve": ...}``,
``{"model_checks": ...}``, ``{"movement_path": ...}``, ``{"um_path": ...}``,
``{"sweep_path": ...}``, ``{"train_path": ...}``, ``{"mesh_path": ...}`` and
``{"kernels": [...]}`` lines, then as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Exits non-zero, with no such line, if a check fails, or if there is no CUDA
card or no port beside this script.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import re
import statistics
import subprocess
import sys
import time
from collections import deque
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

GB = 2**30


def paper_working_set() -> int:
    """``harness.run_cell``'s working set for the paper's 16 GiB Volta
    (``intel-volta-pcie``) in the ``in_memory`` regime: 0.8 x 16 GiB."""
    from repro_torch.umbench.harness import REGIMES
    from repro_torch.umbench.platforms import INTEL_VOLTA

    return int(REGIMES["in_memory"] * INTEL_VOLTA.device_mem_gb * GB)


try:
    WORKING_SET = paper_working_set()
except ImportError:  # no port beside this script: main() says so and fails
    WORKING_SET = 0
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
PEAK_TF32_FLOPS = 495e12    # dense tensor cores
PEAK_BF16_FLOPS = 989e12    # dense tensor cores
BS_OPS_PER_OPTION = 60      # the BS app's model (FLOPS_PER_ELEM)
FDTD_OPS_PER_CELL = 29      # c0*x, then 4 x (5 adds, 1 mul, 1 add)
# The SGEMM against fp64 on a sample of rows: those of the last 128-row
# tile (partial at n = 33,842) and seeded others, GEMM_FP64_ROWS in all, all
# N columns, computed GEMM_FP64_COLS columns at a time.  The kernel's largest
# error may be at most GEMM_FP64_FACTOR times that of torch.matmul in fp32
# on the same rows.  3xTF32 keeps fp32's accuracy; a one-pass TF32 product,
# with 10 bits of mantissa, errs ~50x more at k = 33,842 and must fail.
GEMM_FP64_ROWS, GEMM_FP64_COLS, GEMM_FP64_FACTOR = 256, 8192, 4.0

SOURCES = {
    "black_scholes": ("src/repro_torch/kernels/csrc/black_scholes.cu",
                      "src/repro/kernels/black_scholes/kernel.py:20"),
    "matmul": ("src/repro_torch/kernels/csrc/streamed_matmul.cu",
               "src/repro/kernels/streamed_matmul/kernel.py:17"),
    "fdtd3d": ("src/repro_torch/kernels/csrc/fdtd3d.cu",
               "src/repro/kernels/fdtd3d/kernel.py:24"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention/kernel.py:26"),
    "paged_attention": ("src/repro_torch/kernels/csrc/paged_attention.cu",
                        "src/repro/kernels/paged_attention/kernel.py:27"),
}

# Attention at full width (src/repro/configs, configs/shapes.py): paged
# decode at qwen2-72b / decode_32k with the demo's page size, flash prefill
# at prefill_32k (one 32k prompt a call), all bf16.
PAGED_MODEL, PAGED_B, PAGED_PAGES, PAGED_PSZ = "qwen2-72b", 128, 512, 64
PAGED_CHECK_GROUP = 8       # sequences per plain-version call
FLASH_S = 32_768
FLASH_CASES = (("qwen2-7b", None), ("mixtral-8x22b", 4096))
FLASH_CHECK_BLOCK = 512     # KV block of the plain attention_flash
FAULT_TILE = 64             # a one-tile fault: no larger than the kernel's 128-key tile
# bf16 at the test shapes, the JAX test's limit: the plain versions round
# scores or p to bf16 before a product, the paged kernel keeps them in fp32
# (tests/test_torch_attention_kernels.py)
BF16_ATOL, BF16_RTOL = 3e-2, 2.0**-6
# paged bf16 at full width, against the plain version run in fp32 on the
# same values.  The kernel's products run on the tensor cores with fp32
# accumulators: Q K^T of bf16 inputs is exact, and P enters P V as two bf16
# parts, hi = bf16(P) and lo = bf16(P - hi), which keep P to ~2^-16, so the
# kernel stays as accurate as fp32 and its one error that matters is the
# rounding of the output to bf16 (at most 2^-8 of |out|).  A single bf16 P
# would fail this limit on short rows, where |out| is large and few terms
# average its rounding out (tests/test_torch_paged_precision.py).  Over the
# 4k-32k positions a row attends, |out| of N(0, 1) data is about
# 0.01-0.03, so atol stays two orders below it.
FULL_ATOL, FULL_RTOL = 1e-4, 2.0**-7
# lengths of the short-row and chunk-edge case at full width: rows where a
# single bf16 P fails FULL_ATOL/FULL_RTOL, and the edges of the bf16
# kernel's 64-position stages and 2,048-position split-KV chunks
PAGED_EDGE_LENS = (1, 63, 64, 65, 640, 2047, 2048, 2049, 4095, 32768)
# short rows at the test shapes, (psz, pages, Hq, Hkv, Dh) with the rows'
# lengths: every template instance of the bf16 kernel (Dh 16-128, one or
# two n8 tiles of heads) and page sizes that are not a multiple of 8, at
# lengths where a single bf16 P fails FULL_ATOL/FULL_RTOL
# (tests/test_torch_paged_precision.py)
PAGED_SHORT_CASES = ((32, 20, 32, 2, 128), (16, 40, 32, 2, 64), (12, 54, 16, 1, 32),
                     (8, 80, 32, 2, 16), (5, 128, 64, 8, 128), (24, 27, 8, 1, 64),
                     (64, 10, 4, 1, 32), (7, 92, 8, 2, 16))
PAGED_SHORT_LENS = (640, 64, 3)
# flash bf16 at full width, against the plain version run in fp32 on the
# same values, elementwise atol + rtol |want| + row_rtol rms_row(want), rms
# over Dh for each (position, head).  The kernel rounds P to bf16 for the
# P V product, as the JAX reference does (p.astype(v.dtype)): that error
# scales with the row's norm, not with each element, so near-zero elements
# of a row that is not near zero need the row term; 2^-8 |want| covers the
# output's own rounding.  The port's attention_flash in bf16, which rounds
# P per 64-key tile, passes it on the CPU, and each one-tile fault of the
# plain version fails it (tests/test_torch_attention_kernels.py).
FLASH_FULL_ATOL, FLASH_FULL_RTOL, FLASH_FULL_ROW_RTOL = 1e-4, 2.0**-8, 2.0**-6

# The serving path: qwen2-7b at full width and depth, bf16, its
# prompts through data.pipeline.prefetched.
SERVE_MODEL, SERVE_B, SERVE_PROMPT, SERVE_GEN = "qwen2-7b", 8, 2048, 32
# The model held on the card: fp32 prefill of CHECK_S tokens then
# CHECK_EXTRA teacher-forced decode steps against the full forward, at the
# JAX test's limit (tests/test_models_smoke.py:108-110).
CHECK_S, CHECK_EXTRA = 256, 4
MODEL_ATOL = MODEL_RTOL = 2e-2
# bf16 against the same weights in fp32: the last-position logits of a
# prefill may differ by at most BF16_LOGIT_REL of their fp32 L2 norm, per
# sequence.  Each of two faults, run in fp32, must move them further: wo
# of layer WO_FAULT_LAYER zeroed, and queries rotated one position ahead
# of the keys in layer ROPE_FAULT_LAYER.  The RoPE fault sits in layer 0:
# with random weights the attention of deeper layers is near uniform, and
# there the same offset moves the logits less than bf16 does
# (tests/test_torch_models.py holds all three on a narrow qwen2-7b).
BF16_LOGIT_REL = 0.05
WO_FAULT_LAYER, ROPE_FAULT_LAYER = 14, 0
# The decode step's route to the paged kernel (decode_route): qwen2-7b at
# full depth, through build_serve_step, at the benchmark's two serve shapes
# (label, B, prompt, generated): the decode cell's cache of 1,280 positions
# (pages of 64) and the prefill cell's of 2,056 (pages of 1,028).  Each
# layer's attention reads its cache in place through the kernel:
# ROUTE_LAUNCHES kernels a layer a step (items, merge).  One layer's route,
# on the post-prefill cache with the slots past the prompt filled, is held
# at cache_len mid, S - 1 and S against the fp64 plain attention at
# FULL_ATOL/FULL_RTOL, a limit that the newest token dropped and a table
# reading another sequence's pages must fail.  The whole step's logits are
# held against the plain route's (repeat_kv + einsum, the predicate made
# false for the capture) on the same caches and tokens at BF16_LOGIT_REL,
# with at least ROUTE_TOKENS_ALIKE of their next tokens the same (0.948 at
# the decode cell's shape: the models' random weights leave near ties that
# the plain route's bf16 scores and P flip), and its graph bit for bit
# against its eager steps.
ROUTE_CASES = (("decode", 16, 1024, 256), ("prefill", 8, 2048, 8))
ROUTE_LAUNCHES, ROUTE_TOKENS_ALIKE = 2, 0.9
PAGED_KERNEL = re.compile(r"paged_(tc|merge)_kernel")
# The movement layer: copy rates of a 256 MiB buffer (median of 5); the
# prefetch iterator over qwen2-vl-2b's vlm batch (B 8, S 4,096, d 1,536),
# PREFETCH_DISTINCT distinct batches of synthetic_batches cycled over
# PREFETCH_STEPS steps, so that a batch handed over a step early or late
# differs from the one expected; streaming of one qwen2-7b layer; remat of a
# 2-layer qwen2-7b in fp32 at S 2,048, the policies held to "none" at the
# JAX test's 1e-5 (tests/test_perf_variants.py:45-46).
COPY_BYTES, COPY_REPS = 256 * 2**20, 5
# The UM sweep engine (um_path).  The paper's five findings on the seed
# cells of the extended matrix, at tests/test_paper_claims.py's thresholds:
# (claim, app, platform, regime, variant, limit) on speedup_vs_um, and for
# claim 4 the Intel-Volta prefetch speed-up above the P9's for each app.
UM_CLAIMS = (
    (1, "bs", "intel-pascal-pcie", "oversubscribed", "um_advise", "1.10 <= s <= 1.6"),
    (1, "bs", "intel-volta-pcie", "oversubscribed", "um_advise", "1.10 <= s <= 1.6"),
    (1, "conv1", "intel-pascal-pcie", "oversubscribed", "um_advise", "s > 1.3"),
    (1, "conv1", "intel-volta-pcie", "oversubscribed", "um_advise", "s > 1.3"),
    (2, "cg", "p9-volta-nvlink", "in_memory", "um_advise", "s > 1.3"),
    (2, "fdtd3d", "p9-volta-nvlink", "in_memory", "um_advise", "s > 1.3"),
    (3, "bs", "p9-volta-nvlink", "oversubscribed", "um_advise", "s < 0.5"),
    (3, "cg", "p9-volta-nvlink", "oversubscribed", "um_advise", "s < 0.5"),
    (4, "cg", "intel-volta-pcie", "in_memory", "um_prefetch", "s > 1.5"),
    (5, "fdtd3d", "intel-pascal-pcie", "in_memory", "explicit", "s > 1.5"),
    (5, "conv1", "intel-volta-pcie", "in_memory", "explicit", "s > 2.0"),
)
UM_CLAIM_LIMITS = {"1.10 <= s <= 1.6": lambda s: 1.10 <= s <= 1.6,
                   "s > 1.3": lambda s: s > 1.3, "s < 0.5": lambda s: s < 0.5,
                   "s > 1.5": lambda s: s > 1.5, "s > 2.0": lambda s: s > 2.0}
UM_CLAIM4_APPS = ("bs", "cg", "fdtd3d")
UM_BREAKDOWN_VARIANTS = ("um", "um_advise", "um_prefetch", "um_both")
UM_KERNELS = (("black_scholes", "bs"), ("matmul", "cublas"), ("fdtd3d", "fdtd3d"))
UM_MAX_S = 30.0
# The serving sweep, the analysis CLI and the benchmark runner (sweep_path).
# The committed BENCH_umbench.json is the JAX package's artifact, read as
# data: SWEEP_SAMPLE of its 216 clean serving cells, a fixed rotation (stride
# 7, coprime with the 12 variants and with 216) over the sweep's spec order.
SWEEP_ARTIFACT = "BENCH_umbench.json"
SWEEP_SAMPLE, SWEEP_STRIDE, SWEEP_CELLS = 24, 7, 216
SWEEP_PATTERNS = ("poisson", "bursty", "diurnal")
SWEEP_PLATFORMS = ("intel-volta-pcie", "p9-volta-nvlink")
SWEEP_FIELDS = ("total_s", "completed", "faults", "evictions")
SWEEP_MAX_S = 90.0
PREFETCH_MODEL, PREFETCH_B, PREFETCH_S = "qwen2-vl-2b", 8, 4096
PREFETCH_STEPS, PREFETCH_DISTINCT, PREFETCH_WARM = 16, 4, 3
# remat_path: each policy's loss and gradients within REMAT_ATOL of
# "none"'s; "offload" (the reference's policy saves and offloads nothing and
# recomputes as "full") bit for bit "full"'s, its peak above the weights
# within REMAT_PEAK_TOL of "full"'s.
REMAT_S, REMAT_ATOL, REMAT_PEAK_TOL = 2048, 1e-5, 0.01
DECODE_PROFILE_STEPS = 4
# The other families, served as qwen2-7b is (B 8, 2,048-token prompts, 32
# tokens) at full width and cut in depth to FAMILY_LAYERS: mixtral-8x22b
# because 56 layers are 282 GB in bf16, rwkv6-3b and hymba-1.5b (32 layers
# each) to keep the script's time with the training path near 300 s: their
# serves are host-bound time loops, the same for every layer.  Their model
# checks run at FAMILY_CHECK_LAYERS (full depth, mixtral's fp32 copy at 2)
# and hold bf16 against fp32 at BF16_LOGIT_REL, where family_fault must fail;
# rwkv and hymba also run
# fp32 prefill + decode against the full forward.  Their prefill is profiled
# at PROFILE_LAYERS: the time loops of the scans launch ~8,000 kernels a
# layer, which the profiler takes seconds to trace, and every layer is alike.
FAMILY_MODELS = ("rwkv6-3b", "hymba-1.5b", "mixtral-8x22b")
FAMILY_LAYERS = {"mixtral-8x22b": 8, "rwkv6-3b": 16, "hymba-1.5b": 16}
FAMILY_CHECK_LAYERS = {"mixtral-8x22b": 2, "rwkv6-3b": 32, "hymba-1.5b": 32}
PROFILE_LAYERS = 1
# rwkv6-3b in bf16 leaves fp32 further than the other models do, in the
# reference as in the port: on a narrow copy (d 256, 32 layers, random
# weights, 64 tokens) JAX's own bf16 logits are 0.147 of fp32's away, the
# port's 0.12-0.14, so its limit is twice the reference's gap; its fault
# moves them 1.2-1.3 (tests/test_torch_families.py)
FAMILY_BF16_LOGIT_REL = {"rwkv6-3b": 0.3}
# one full-width mixtral MoE layer, fp32, against a per-token loop over
# MOE_LOOP_TOKENS tokens, with a capacity that drops nothing
MOE_LOOP_TOKENS, MOE_LOOP_ATOL, MOE_LOOP_RTOL = 512, 1e-4, 1e-4
# the library's matrix-product kernels, by name, in a profile
GEMM_KERNEL = re.compile(r"gemm|nvjet|cutlass|xmma", re.IGNORECASE)
# the host's calls that put work on the card: kernel and graph launches,
# copies and fills (the graph step's two input copies a token)
HOST_LAUNCH_API = re.compile(r"^cu(da)?(LaunchKernel|GraphLaunch|Memcpy|Memset)")
# The training path: starcoder2-3b at full width and depth (30 layers, 3.03 B
# parameters), bf16 with fp32 masters, through launch.train.train for
# TRAIN_STEPS steps with the state on the card, then build_train_step for
# TRAIN_HOST_STEPS under the planner's escalated plan (int8 moments, the
# optimizer state in pinned host memory).  train_4k's 256 x 4,096 tokens
# are cut to B 8 x S 2,048: one layer's recompute holds the dense
# attention's fp32 scores, 8 x 24 x S^2 x 4 bytes (3.2 GB a tensor at 2,048,
# four times that at 4,096).
TRAIN_MODEL, TRAIN_B, TRAIN_S = "starcoder2-3b", 8, 2048
TRAIN_STEPS, TRAIN_HOST_STEPS = 8, 4
# Checks on a 2-layer cut at full width, B 8 x S 2,048: the optimizer on the
# host against the card, bit for bit over TRAIN_CUT_STEPS steps from step
# TRAIN_CUT_AT (past the 100-step warmup); bf16 against fp32 on the same
# weights, the loss's relative gap and the relative L2 of all gradients at
# most twice the reference's own gap on narrow 2-layer copies
# (TRAIN_NARROW, 2 x 256 tokens, seeds 0-2: JAX's loss gap 3.4e-6-2.0e-5,
# its gradients' 0.0098-0.0106; tests/test_torch_train.py); apply_updates
# on the card against the same function in fp64 on the CPU, the fp32 state
# within TRAIN_STATE_RTOL of each leaf's largest magnitude and int8 codes
# equal but within TRAIN_EDGE of a rounding edge, where dropping the bias
# correction must fail.
TRAIN_CUT_LAYERS, TRAIN_CUT_STEPS, TRAIN_CUT_AT = 2, 3, 100
# The compiled train step (launch.step.GraphTrainStep) against its eager
# body, one run after the other from the same seed under deterministic
# algorithms: on the cut (TRAIN_CUT_STEPS steps, the state on the card and
# on the host, fp32 and int8 moments) every tensor bit for bit, at full
# depth TRAIN_GRAPH_STEPS steps, the params bit for bit and every state
# tensor's digest alike; on the cut, graph steps in the warmup with the step
# buffer left unfilled (the lr frozen) must differ.  A warm graph step makes
# at most TRAIN_GRAPH_MAX_CALLS host launch calls: the graph's launch, one
# copy a batch tensor and the step's fill.
TRAIN_GRAPH_STEPS, TRAIN_GRAPH_MAX_CALLS = 4, 5
TRAIN_NARROW = dict(d_model=384, num_heads=12, num_kv_heads=1, head_dim=32, d_ff=1536,
                    vocab_size=4096)
TRAIN_BF16_LOSS_REL, TRAIN_BF16_GRAD_REL = 4.5e-5, 0.022
TRAIN_STATE_RTOL, TRAIN_EDGE = 1e-6, 1e-3
# The reduced-config drills of tests/test_end_to_end.py on the card.  The
# card's backward adds with atomics, so a run restarted from a checkpoint
# ends within TRAIN_RESTART_RTOL of an uninterrupted one, not bit for bit
# (tests/test_torch_train.py holds that on the CPU).
TRAIN_RESTART_RTOL = 1e-3
# The mesh path (repro_torch.launch.mesh / sharding / step on a mesh): the
# 2-layer cut of train_path's checks, one step in each sharding mode on a
# (1, 1) mesh over NCCL, held against the unsharded step on the same weights
# and batch: the loss and every updated parameter within MESH_STEP_TOL of
# each tensor's largest value.  The dry-run (launch/dryrun.py) runs in a
# subprocess on the fake backend, started early so that it overlaps the card's
# phases: starcoder2-3b / train_4k on the 16 x 16 mesh, then the cut and the
# full depth on a 1 x 1 mesh at B x S of train_path.  The cut's traced peak
# must lie within MESH_PEAK_TOL of the sharded 2d step's measured
# max_memory_allocated, both ways.  The full-depth trace's peak is printed
# beside train_path's measured one from the same run.
MESH_MODES = ("2d", "fsdp", "zero1")
MESH_STEP_TOL, MESH_PEAK_TOL = 1e-6, 0.10
MESH_DRYRUN_TIMEOUT = 900
MESH_DRYRUN = r"""
import dataclasses, json, sys, time
import torch
torch.set_num_threads(2)
from repro_torch.configs import ShapeConfig, get_config
from repro_torch.launch import dryrun
outdir, batch, seq, cut = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
out = {}
t = time.perf_counter()
out["cell"] = dryrun.run_cell("starcoder2-3b", "train_4k", multi_pod=False, outdir=outdir)
out["cell_s"] = time.perf_counter() - t
arch = get_config("starcoder2-3b")
shape = ShapeConfig("cut", seq, batch, "train")
mesh = dryrun.dryrun_mesh((1, 1), ("data", "model"))
for name, layers in (("cut", cut), ("full", arch.model.num_layers)):
    a = dataclasses.replace(arch, model=dataclasses.replace(arch.model, num_layers=layers))
    t = time.perf_counter()
    out[name] = dryrun.trace_step(a, shape, mesh)
    out[name + "_s"] = time.perf_counter() - t
print(json.dumps(out))
"""


@contextlib.contextmanager
def routing(choices: list, replay: bool = False):
    """Record each MoE call's top-k expert choices into ``choices``, or,
    with ``replay``, have each call take the recorded choices in turn, its
    gates still its own router's probabilities at them.  A bf16 run and an
    fp32 run then route alike: a near-tie in the router flips a token's
    expert under bf16 rounding, and the logits with it (on a narrow 2-layer
    mixtral, one seed in 16 moved them 0.50 of their norm)."""
    from repro_torch.models import moe as moe_lib

    real, recorded = moe_lib._top_k, iter(list(choices))

    def top_k(probs, k):
        if replay:
            idx = next(recorded)
            return probs.gather(-1, idx), idx
        vals, idx = real(probs, k)
        choices.append(idx)
        return vals, idx

    moe_lib._top_k = top_k
    try:
        yield
    finally:
        moe_lib._top_k = real


@contextlib.contextmanager
def family_fault(params):
    """One logic fault in a model of the moe, ssm or hybrid family, undone
    on exit: rwkv's token shift ignored in layer 0 (its mixes zeroed),
    hymba's Mamba D skip dropped in layer 0, MoE gates not renormalised."""
    import torch

    from repro_torch.models import moe as moe_lib

    family = params.cfg.family
    if family == "moe":
        real = moe_lib._renormalise
        moe_lib._renormalise = lambda gates: gates
        try:
            yield "MoE gates not renormalised"
        finally:
            moe_lib._renormalise = real
        return
    blk = params.blocks[0]
    if family == "ssm":
        label = "token shift ignored in layer 0"
        faulty = [p for n, p in blk.named_parameters() if n.split(".")[-1].startswith("mu_")]
    else:
        label = "Mamba D skip dropped in layer 0"
        faulty = [blk.mamba.D]
    saved = [p.detach().clone() for p in faulty]
    with torch.no_grad():
        for p in faulty:
            p.zero_()
    try:
        yield label
    finally:
        with torch.no_grad():
            for p, s in zip(faulty, saved):
                p.copy_(s)


@contextlib.contextmanager
def slot_not_loaded(step, layer: int):
    """The compiled prefill's fault, undone on exit: the slot does not take
    layer ``layer``'s weights before that layer's replay, which then runs
    on the weights of the layer before it (``GraphPrefillStep._load``)."""
    calls, real = iter(range(1 << 30)), step._load
    step._load = lambda weights: None if next(calls) == layer else real(weights)
    try:
        yield f"layer {layer}'s weights not copied into the slot"
    finally:
        del step._load


@contextlib.contextmanager
def step_not_filled(step):
    """The compiled train step's fault, undone on exit: each call fills the
    batch buffers but leaves the step buffer as it was, so each replay
    computes the lr of the step the buffer last held, as an lr frozen at
    capture would (``GraphTrainStep._fill``)."""
    real = step._fill
    step._fill = lambda batch, n: real(batch, step._step.clone())
    try:
        yield "the step buffer left unfilled"
    finally:
        del step._fill


@contextlib.contextmanager
def plain_route(tf):
    """The decode step's plain attention on a card (repeat_kv + einsum, as
    before the paged route): the route's predicate made false."""
    real = tf.paged_decode_ok
    tf.paged_decode_ok = lambda cache, heads: False
    try:
        yield
    finally:
        tf.paged_decode_ok = real


def rel_l2(pairs) -> float:
    """sqrt(sum |got - want|^2 / sum |want|^2) over (got, want) pairs of
    float arrays or tensors."""
    num = den = 0.0
    for got, want in pairs:
        d = got - want
        num += float((d * d).sum())
        den += float((want * want).sum())
    return math.sqrt(num / den)


def train_bf16_gap(tf, params, cfg, batch) -> dict:
    """The loss and gradients of ``params`` (bf16) against the same weights
    in fp32, under remat "full": the loss's relative gap and the relative
    L2 of all gradients together.  Leaves ``params`` in fp32."""
    import dataclasses

    import torch

    loss = tf.loss_fn(params, batch, cfg)
    got = [g.float() for g in torch.autograd.grad(loss, list(params.parameters()))]
    params.float()
    want = tf.loss_fn(params, batch, dataclasses.replace(cfg, dtype="float32"))
    grads = torch.autograd.grad(want, list(params.parameters()))
    return {"loss": abs(loss.item() - want.item()) / abs(want.item()),
            "grads": rel_l2(zip(got, grads))}


def int8_edges(prev: dict, grads: dict, new: dict, cfg, edge: float) -> dict:
    """Per parameter name, where an int8 AdamW step from the state leaves
    ``prev`` with ``grads`` puts m and sqrt(v), in fp64, within ``edge`` of
    a rounding edge at the scales of the state leaves ``new``: there two
    correct computations may round to codes one apart."""
    import torch

    out = {}
    for n, g in grads.items():
        s, g = prev[n], g.double()
        m = s["m"].double() * s["m_scale"].double()
        v = torch.square(s["v"].double() * s["v_scale"].double())
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * g * g
        out[n] = {}
        for key, x in (("m", m), ("v", torch.sqrt(v))):
            r = (x / new[n][key + "_scale"].double()).abs()
            out[n][key] = ((r - r.floor()) - 0.5).abs() < edge
    return out


def row_scaled_limit(want, atol, rtol, row_rtol=0.0):
    """atol + rtol |want| + row_rtol rms(want over its last axis), in fp32;
    ``want`` stays as it was."""
    limit = want.float().abs()
    limit.mul_(rtol).add_(atol)
    if row_rtol:
        limit.add_(want.float().square().mean(-1, keepdim=True).sqrt_().mul_(row_rtol))
    return limit


def wrong_v_tile(v, tile=FAULT_TILE):
    """A copy of v (B, S, H, Dh) whose ``tile`` positions at S/2 hold the
    ``tile`` positions before them: what a wrong KV tile index reads."""
    half = v.shape[1] // 2
    bad = v.clone()
    bad[:, half:half + tile] = v[:, half - tile:half]
    return bad


def start_dryrun():
    """The mesh path's dry-run, in a process of its own (the fake process
    group must not live in this one)."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.Popen(
        [sys.executable, "-c", MESH_DRYRUN, str(ROOT / "artifacts" / "torch_dryrun"),
         str(TRAIN_B), str(TRAIN_S), str(TRAIN_CUT_LAYERS)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def mesh_cut():
    """train_path's 2-layer full-width cut of starcoder2-3b and its shape."""
    import dataclasses

    from repro_torch.configs import ShapeConfig, get_config

    arch = get_config(TRAIN_MODEL)
    arch = dataclasses.replace(arch, model=dataclasses.replace(
        arch.model, num_layers=TRAIN_CUT_LAYERS))
    return arch, ShapeConfig("cut", TRAIN_S, TRAIN_B, "train")


def mesh_rank(rank: int, n: int, store: str, outdir: str, arch, shape, device: str) -> None:
    """One rank of the (1, n) mesh (NCCL over n cards; gloo on the CPU for a
    rehearsal): a 2d step of the cut, and the int8 compressed mean of its
    gradients scaled by (1 + rank) against the plain mean; rank 0 saves
    what it found."""
    import itertools

    import torch
    import torch.distributed as dist
    from torch.distributed import _functional_collectives as funcol

    from repro_torch.data import DataConfig, synthetic_batches
    from repro_torch.launch import step as stp
    from repro_torch.launch.mesh import mesh_context
    from repro_torch.models import init_params
    from repro_torch.models import transformer as tf
    from repro_torch.optim import adamw
    from repro_torch.runtime import compressed_psum, quantize_int8

    from torch.distributed.device_mesh import init_device_mesh

    if device == "cuda":
        torch.cuda.set_device(rank)
        dev = torch.device("cuda", rank)
        dist.init_process_group("nccl", store=dist.FileStore(store, n), rank=rank,
                                world_size=n, device_id=dev)
    else:
        dev = torch.device(device)
        dist.init_process_group("gloo", store=dist.FileStore(store, n), rank=rank, world_size=n)
    mesh = init_device_mesh(dev.type, (1, n), mesh_dim_names=("data", "model"))
    cfg = arch.model
    batch = {k: torch.from_numpy(v).to(dev) for k, v in next(itertools.islice(
        synthetic_batches(cfg, shape, DataConfig(seed=2)), 1)).items()}
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(3), dev)
    names, leaves = zip(*params.named_parameters())
    grads = torch.autograd.grad(tf.loss_fn(params, batch, cfg, remat=arch.train.remat), leaves)
    worst = 0.0
    for g in grads:
        mine = g.float() * (1 + rank)
        mean, _ = compressed_psum(mine, dist.group.WORLD, torch.zeros_like(mine))
        plain = funcol.all_reduce(mine, "sum", dist.group.WORLD) / n
        scale = funcol.all_reduce(quantize_int8(mine)[1], "max", dist.group.WORLD)
        worst = max(worst, ((mean - plain).abs().max() / scale).item())
    del grads
    opt = adamw.init_state(params, stp._adamw_cfg(arch, None))
    params, opt = stp.place_train_state(arch, params, opt, mesh)
    step = stp.build_train_step(arch, shape, mesh)
    _, opt, m = step(params, opt, batch, TRAIN_CUT_AT)
    with mesh_context(mesh):
        full = {k: p.full_tensor().detach().cpu().clone() for k, p in params.named_parameters()}
    # the step's ms (host clock around a synchronised step) and its collectives
    from repro_torch.launch.analysis import TraceCounter
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t = time.perf_counter()
    step(params, opt, batch, TRAIN_CUT_AT + 1)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    ms = (time.perf_counter() - t) * 1e3
    counter = TraceCounter()
    with counter:
        step(params, opt, batch, TRAIN_CUT_AT + 2)
    if rank == 0:
        torch.save({"params": full, "loss": float(m["loss"]), "psum_steps": worst,
                    "grad_norm": float(m["grad_norm"]), "lr": float(m["lr"]), "step_ms": ms,
                    "collectives": counter.collectives().as_dict()},
                   Path(outdir) / "mesh_rank0.pt")
    dist.destroy_process_group()


class GraphHeld:
    """The CUDA-graph decode of one ``serve`` held against eager decode.
    While open, ``launch.serve``'s decode steps are recorded: at the
    capture, before the decode timer, two copies of the post-prefill caches
    (their peak is below the prefill's); ``check`` then runs the eager
    steps."""

    def __init__(self, smoke, tf):
        self.smoke, self.tf, self.seen = smoke, tf, {}

    def __enter__(self):
        from repro_torch.launch import serve as serve_mod

        self.serve_mod, self.real = serve_mod, serve_mod.build_serve_step

        def recording(arch, mesh=None, *, device=None):
            step = self.real(arch, mesh, device=device)
            capture = step.capture

            def copy_then_capture(params, batch, caches, cache_len):
                self.seen.update(step=step, params=params, caches=caches, **{
                    name: {k: v.clone() for k, v in caches.items()}
                    for name in ("eager", "pristine")})
                capture(params, batch, caches, cache_len)

            step.capture = copy_then_capture
            return step

        serve_mod.build_serve_step = recording
        return self

    def __exit__(self, *exc):
        self.serve_mod.build_serve_step = self.real
        self.seen.clear()

    def check(self, label, toks, rec) -> dict:
        """Run the serve's SERVE_GEN - 1 decode steps again as eager
        ``decode_step``s on the copy of the post-prefill caches, with the
        tokens the serve fed (its own, each step's input the token before)
        and cache_len counting up from the prompt's length, as device
        scalars; the graph's logits and tokens must equal them bit for bit.
        Then the faults: from the post-prefill caches, step 0 replayed (it
        must give the eager step 0's logits again), then step 1 replayed
        with cache_len left at step 0's (or, where the step reads no
        cache_len, rwkv's, from the post-prefill state), which must differ
        from the eager step 1; and the graph must refuse other caches."""
        smoke, torch, tf, seen = self.smoke, self.smoke.torch, self.tf, self.seen
        step, params, caches = seen["step"], seen["params"], seen["caches"]
        cfg, graph_logits = step.cfg, rec["logits"][1:]
        tokens = torch.from_numpy(toks).to(DEVICE)
        lens = [torch.tensor(SERVE_PROMPT + i, dtype=torch.int32, device=DEVICE)
                for i in range(len(graph_logits))]
        eager = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i, n in enumerate(lens):  # as serve's loop: the step, argmax, tokens to the host
            logits, _ = tf.decode_step(params, {"tokens": tokens[:, i]}, seen["eager"], n, cfg)
            eager.append(logits)
            logits.argmax(dim=-1).cpu()
        torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t0) * 1e3 / len(lens)
        differ = [i for i, (g, e) in enumerate(zip(graph_logits, eager))
                  if not torch.equal(g, e)]
        max_diff = max((g.float() - e.float()).abs().max().item()
                       for g, e in zip(graph_logits, eager))
        eager_toks = torch.stack([e.argmax(dim=-1) for e in eager], dim=1).cpu().numpy()
        smoke.expect(f"{label}: graph decode == eager decode_step bit for bit, logits of "
                     f"{len(lens)} steps ({len(differ)} differ, max |diff| {max_diff:.3e}) and "
                     f"tokens", not differ and (eager_toks == toks[:, 1:]).all())

        def replay(tok, n, fresh):
            if fresh:
                for k, v in caches.items():
                    v.copy_(seen["pristine"][k])
            step(params, {"tokens": tokens[:, tok]}, caches, lens[n])
            return step.logits

        smoke.expect(f"{label}: a replay from the post-prefill caches gives step 0's logits "
                     "again",
                     torch.equal(replay(0, 0, True), eager[0]))
        if cfg.family == "ssm":
            fault, got = "the state left at the prompt's", replay(1, 1, True)
        else:
            fault, got = "cache_len left un-advanced", replay(1, 0, False)
        fault_diff = (got.float() - eager[1].float()).abs().max().item()
        smoke.expect(f"{label}: the comparison rejects step 1 replayed with {fault} "
                     f"(max |diff| {fault_diff:.3e})", not torch.equal(got, eager[1]))
        smoke.expect_raise(f"{label}: the graph step refuses caches it was not captured on",
                           lambda: step(params, {"tokens": tokens[:, 0]}, seen["pristine"],
                                        lens[0]), ValueError)
        out = {"eager_ms_per_token": eager_ms, "graph_ms_per_token": rec["decode_ms_per_token"],
               "capture_ms": rec["capture_ms"], "steps": len(lens),
               "steps_differing": len(differ), "max_abs_diff": max_diff,
               "fault": fault, "fault_max_abs_diff": fault_diff}
        print(f"{label}: decode {rec['decode_ms_per_token']:.2f} ms a token as a CUDA graph, "
              f"{eager_ms:.2f} eager, capture {rec['capture_ms']:.1f} ms [{smoke.card}]")
        del eager, graph_logits
        return out


class PrefillHeld:
    """The compiled prefill of one ``serve`` held against the eager
    ``tf.prefill``.  While open, ``launch.serve``'s prefill step is
    recorded with the params and prompt batch it prefilled, and its cold
    call (the capture included) timed on the host clock with the device
    synchronised, beside the device memory before it and the peak after
    it; ``check`` then runs the eager prefill and a warm call of the same
    step."""

    def __init__(self, smoke, tf):
        self.smoke, self.tf, self.seen = smoke, tf, {}

    def __enter__(self):
        from repro_torch.launch import serve as serve_mod

        torch, seen = self.smoke.torch, self.seen
        self.serve_mod, self.real = serve_mod, serve_mod.build_prefill_step

        class Timed:
            def __init__(self, step):
                self.step = step

            def __getattr__(self, name):  # logits, capture_ms
                return getattr(self.step, name)

            def __call__(self, params, batch):
                torch.cuda.synchronize()
                before = torch.cuda.memory_allocated()
                t0 = time.perf_counter()
                out = self.step(params, batch)
                torch.cuda.synchronize()
                seen.update(step=self.step, params=params, batch=batch,
                            cold_ms=(time.perf_counter() - t0) * 1e3,
                            cold_before=before, cold_peak=torch.cuda.max_memory_allocated())
                return out

        def recording(arch, mesh=None):
            return Timed(self.real(arch, mesh))

        serve_mod.build_prefill_step = recording
        return self

    def __exit__(self, *exc):
        self.serve_mod.build_prefill_step = self.real
        self.seen.clear()

    def timed(self, fn):
        """fn()'s result, its host ms (the device synchronised) and the
        device memory it took above what was allocated before it."""
        torch = self.smoke.torch
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3, torch.cuda.max_memory_allocated() - before

    def check(self, label, rec) -> dict:
        """The served prompt batch prefilled again by a warm call of the
        serve's step and by the eager ``tf.prefill``: the cold call's
        logits (the serve's first), and the warm call's logits and every
        cache tensor, must equal the eager ones bit for bit, and the step
        must keep the one graph it captured.  The faults: a warm call with
        one layer's weights left out of the slot (``slot_not_loaded``) must
        change the logits, and a prompt a token shorter must be refused.
        One warm call runs under torch.profiler: one ``cudaGraphLaunch`` a
        layer.  The step, whose graph holds a memory pool of one layer's
        transients, is released before the eager prefill (mixtral's pool
        and the eager prefill's transients together exceed the card)."""
        smoke, torch, tf, seen = self.smoke, self.smoke.torch, self.tf, self.seen
        step, params, batch = seen.pop("step"), seen["params"], seen["batch"]
        cfg, graph, L = step.cfg, step.graph, len(params.blocks)
        smoke.expect(f"{label}: the prefill step captured one layer's CUDA graph",
                     graph is not None)
        (_, got), warm_ms, warm_mem = self.timed(lambda: step(params, batch))
        got_logits = step.logits
        with slot_not_loaded(step, L // 2) as fault:
            step(params, batch)
        fault_logits = step.logits
        short = {k: v[:, :-1] for k, v in batch.items()}
        smoke.expect_raise(f"{label}: the prefill step refuses a prompt of "
                           f"{next(iter(short.values())).shape[1]} tokens",
                           lambda: step(params, short), ValueError)
        prof = smoke.profile_calls(((f"prefill graph of {L} layers",
                                     lambda: step(params, batch), 1),))
        prof = next(iter(prof.values()))
        launches = prof["host_launch_calls_by_api"].get("cudaGraphLaunch", 0)
        smoke.expect(f"{label}: a warm graph prefill launches {launches:g} graphs, one a layer "
                     f"({L})", launches == L)
        smoke.expect(f"{label}: the prefill step kept the graph it captured", step.graph is graph)
        slot_bytes = sum(p.numel() * p.element_size() for p in step.slot.parameters())
        capture_ms = step.capture_ms
        del step, graph
        smoke.free()
        (want_logits, want), eager_ms, eager_mem = self.timed(
            lambda: tf.prefill(params, batch, cfg))
        differ = [k for k in want if not torch.equal(got[k], want[k])]
        same = (torch.equal(rec["logits"][0], want_logits)
                and torch.equal(got_logits, want_logits) and not differ)
        max_diff = max([(got_logits.float() - want_logits.float()).abs().max().item()]
                       + [(got[k].float() - want[k].float()).abs().max().item() for k in want])
        smoke.expect(f"{label}: graph prefill == eager tf.prefill bit for bit: the cold and a "
                     f"warm call's logits, the warm call's caches {sorted(want)} (differ: "
                     f"{differ}, max |diff| {max_diff:.3e})", same)
        fault_diff = (fault_logits.float() - want_logits.float()).abs().max().item()
        smoke.expect(f"{label}: the comparison rejects the prefill with {fault} (max |diff| "
                     f"{fault_diff:.3e})", not torch.equal(fault_logits, want_logits))
        del got, want
        out = {"cold_ms": seen["cold_ms"], "capture_ms": capture_ms, "warm_ms": warm_ms,
               "eager_ms": eager_ms, "layers": L, "max_abs_diff": max_diff,
               "fault": fault, "fault_max_abs_diff": fault_diff,
               "cold_peak_bytes": seen["cold_peak"],
               "cold_above_bytes": seen["cold_peak"] - seen["cold_before"],
               "warm_above_bytes": warm_mem, "eager_above_bytes": eager_mem,
               "slot_bytes": slot_bytes, "profile": prof,
               "host_launch_calls_per_layer": prof["host_launch_calls"] / L}
        print(f"{label}: prefill as one layer's CUDA graph over {L} layers: cold "
              f"{seen['cold_ms']:.1f} ms (capture {capture_ms:.1f}), warm {warm_ms:.1f}, "
              f"eager {eager_ms:.1f}; {prof['host_launch_calls']:g} host launch calls a prefill "
              f"({out['host_launch_calls_per_layer']:.2f} a layer), busy "
              f"{prof['device_busy_share'] or float('nan'):.3f}; peak {seen['cold_peak']} bytes, "
              f"the cold call {out['cold_above_bytes']} above what it found (slot "
              f"{slot_bytes}), a warm call {warm_mem}, the eager prefill {eager_mem} "
              f"[{smoke.card}]")
        return out


@contextlib.contextmanager
def deterministic(torch):
    """Deterministic algorithms while open (warnings, not errors, where an
    operation has none): two runs of one step give the same bits."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


def bits_digest(x) -> tuple[int, int]:
    """Two int64 sums over a tensor's elements read as signed integers of
    their width, and over their squares (wrapping): equal for equal bits, and
    a change of any one element changes the first."""
    import torch

    w = x.detach().view({1: torch.int8, 2: torch.int16, 4: torch.int32,
                         8: torch.int64}[x.element_size()]).to(torch.int64)
    return int(w.sum()), int((w * w).sum())


class TrainHeld:
    """The compiled train step (``launch.step.GraphTrainStep``) held against
    its eager body.  While open, the step that ``launch.train.train``
    builds is kept in ``step``, so that the caller can read its capture and
    profile it on the run's params; ``check`` runs the same steps from the
    same seed through the graph and eagerly, one run after the other, each
    freed before the next, and holds them bit for bit."""

    def __init__(self, smoke):
        self.smoke, self.step = smoke, None

    def __enter__(self):
        from repro_torch.launch import train as train_mod

        self.train_mod, self.real = train_mod, train_mod.build_train_step

        def recording(*args, **kwargs):
            self.step = self.real(*args, **kwargs)
            return self.step

        train_mod.build_train_step = recording
        return self

    def __exit__(self, *exc):
        self.train_mod.build_train_step = self.real
        self.step = None

    def run(self, arch, shape, plan, batches, steps, seed, mode, *, exact=True,
            refuse=False, probe=False) -> dict:
        """``len(steps)`` steps from params seeded with ``seed`` and a fresh
        state (in pinned memory under a host plan): through a
        ``GraphTrainStep`` ("graph"), through its body called eagerly with
        the step as a device tensor ("eager"), or through the graph with
        ``step_not_filled`` from the second step ("fault").  Returns the
        losses, ms a step, the capture's ms, the peaks, and the final
        params and state: copies on the card, or with ``exact`` False the
        params on the host and a ``bits_digest`` of every state tensor.
        With ``refuse`` the graph must then refuse other params; with
        ``probe`` the run also records the pinned allocator's bytes before
        the first step and after each, and profiles one more warm step
        (after the final tensors are copied) with ``Smoke.profile_calls``."""
        smoke, torch = self.smoke, self.smoke.torch
        from repro_torch.checkpoint.checkpointer import tree_leaves
        from repro_torch.core.advise import MemorySpace
        from repro_torch.core.streaming import offload_params
        from repro_torch.launch.step import GraphTrainStep, _adamw_cfg, build_train_step
        from repro_torch.models import init_params
        from repro_torch.optim import init_state

        cfg = arch.model
        smoke.free()
        torch.cuda.reset_peak_memory_stats()

        def fresh(s):
            return init_params(cfg, torch.Generator(device=DEVICE).manual_seed(s), DEVICE)

        params = fresh(seed)
        opt = init_state(params, _adamw_cfg(arch, plan))
        if plan is not None and plan.opt_space is MemorySpace.HOST:
            opt = offload_params(opt, DEVICE)
        step = build_train_step(arch, shape, None, plan, device=DEVICE)
        if not isinstance(step, GraphTrainStep):
            raise TypeError(f"build_train_step gave {type(step).__name__}, not GraphTrainStep")
        losses, ms, fault = [], [], None
        pinned = [torch.cuda.host_memory_stats().get("allocated_bytes.current")]
        for i, (b, n) in enumerate(zip(batches, steps)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if mode == "eager":
                m = step.body(params, opt, b, torch.tensor(n, dtype=torch.int32, device=DEVICE))[2]
            else:
                with (step_not_filled(step) if mode == "fault" and i
                      else contextlib.nullcontext()) as fault:
                    m = step(params, opt, b, n)[2]
            losses.append(float(m["loss"]))
            ms.append((time.perf_counter() - t0) * 1e3)
            pinned.append(torch.cuda.host_memory_stats().get("allocated_bytes.current"))
        torch.cuda.synchronize()
        out = {"losses": losses, "step_ms": ms, "capture_ms": step.capture_ms, "fault": fault,
               "peak_allocated": torch.cuda.max_memory_allocated(),
               "peak_reserved": torch.cuda.max_memory_reserved()}
        if refuse:
            other = fresh(seed + 1)
            smoke.expect_raise("the graph train step refuses params it was not captured on",
                               lambda: step(other, opt, batches[0], steps[0]), ValueError)
            del other
        if exact:
            out["leaves"] = [x.detach().to(DEVICE, copy=True) for x in tree_leaves((params, opt))]
        else:
            out["params"] = [p.detach().cpu() for p in params.parameters()]
            out["digests"] = [bits_digest(x) for x in tree_leaves(opt)]
        if probe:
            out["pinned_by_step"] = pinned
            out["profile"] = smoke.profile_calls((("warm graph step", lambda: step(
                params, opt, batches[-1], steps[-1] + 1), 1),))["warm graph step"]
        del params, opt, step, m
        smoke.free()
        return out

    @staticmethod
    def differ(a: dict, b: dict) -> tuple[int, int, float]:
        """(tensors that differ, tensors compared, largest |a - b| over the
        params and the state copies compared whole) between two runs."""
        if "leaves" in a:
            pairs = list(zip(a["leaves"], b["leaves"]))
            digests = []
        else:
            pairs = list(zip(a["params"], b["params"]))
            digests = list(zip(a["digests"], b["digests"]))
        apart = [(x, y) for x, y in pairs if not x.equal(y)]
        worst = max([(x.double() - y.double()).abs().max().item() for x, y in apart],
                    default=0.0)
        return (len(apart) + sum(x != y for x, y in digests), len(pairs) + len(digests), worst)

    def check(self, label, arch, shape, plan, batches, steps, seed, *, exact=True,
              refuse=False, probe=False):
        """A graph run and an eager run of ``steps`` (``run``, ``probe`` for
        the graph run); they must agree bit for bit, or, where a second
        eager run differs from the first, within that gap, which is printed.
        Returns (the record, the graph run, the eager run)."""
        smoke = self.smoke
        graph = self.run(arch, shape, plan, batches, steps, seed, "graph", exact=exact,
                         refuse=refuse, probe=probe)
        eager = self.run(arch, shape, plan, batches, steps, seed, "eager", exact=exact)
        apart, of, worst = self.differ(graph, eager)
        loss_gap = max(abs(x - y) for x, y in zip(graph["losses"], eager["losses"]))
        kept = ("losses", "step_ms", "capture_ms", "peak_allocated", "peak_reserved")
        rec = {"steps": list(steps), "tensors_differing": apart, "tensors": of,
               "max_abs_diff": worst, "loss_max_abs_diff": loss_gap,
               "graph": {k: graph[k] for k in kept + ("pinned_by_step", "profile")
                         if k in graph},
               "eager": {k: eager[k] for k in kept}}
        ok = apart == 0 and loss_gap == 0.0
        if not ok:  # the gap between two eager runs, which the graph is held to
            again = self.run(arch, shape, plan, batches, steps, seed, "eager", exact=exact)
            gap = self.differ(eager, again)
            gap_loss = max(abs(x - y) for x, y in zip(eager["losses"], again["losses"]))
            rec["eager_vs_eager"] = {"tensors_differing": gap[0], "max_abs_diff": gap[2],
                                     "loss_max_abs_diff": gap_loss}
            ok = gap[0] > 0 and worst <= gap[2] and loss_gap <= gap_loss
            del again
        smoke.expect(f"{label}: {len(steps)} steps through the CUDA graph == eager, "
                     f"{apart} of {of} tensors differ (max |diff| {worst:.3e}, loss "
                     f"{loss_gap:.3e})" + (f", two eager runs: {rec['eager_vs_eager']}"
                                           if "eager_vs_eager" in rec else ", bit for bit"), ok)
        print(f"{label}: ms a step, graph {graph['step_ms']} (capture {graph['capture_ms']:.1f}),"
              f" eager {eager['step_ms']}; peaks allocated / reserved, graph "
              f"{graph['peak_allocated']} / {graph['peak_reserved']}, eager "
              f"{eager['peak_allocated']} / {eager['peak_reserved']} [{smoke.card}]")
        return rec, graph, eager


class Smoke:
    """Runs the phases and keeps what they found."""

    def __init__(self, torch, kernels, apps):
        self.torch = torch
        self.kernels = kernels
        self.apps = apps
        self.counters = {"black_scholes": kernels.black_scholes,
                         "matmul": kernels.matmul,
                         "fdtd3d": kernels.fdtd3d_step,
                         "flash_attention": kernels.flash_attention,
                         "paged_attention": kernels.paged_attention}
        self.failures: list[str] = []
        self.rows: list[dict] = []
        self.power_limit = "unknown"
        self.card = "unknown"
        self.train_full_peak = None  # train_path's full-depth max_memory_allocated

    # -- helpers ---------------------------------------------------------

    @staticmethod
    def compare(got, want, atol, rtol, row_rtol=0.0) -> tuple[float, int, float, float]:
        """(largest |got - want|, how many elements exceed the limit
        ``row_scaled_limit``, mean |want|, largest |got - want| / limit)."""
        err = got.float() - want.float()
        err.abs_()
        if not err.numel():
            return 0.0, 0, 0.0, 0.0
        max_err = err.max().item()
        mean_want = want.float().abs().mean().item()
        limit = row_scaled_limit(want, atol, rtol, row_rtol)
        bad = int((err > limit).sum().item())
        err.div_(limit).nan_to_num_(nan=0.0, posinf=math.inf)  # 0 / 0: no error
        return max_err, bad, mean_want, err.max().item()

    def check(self, label, got, want, atol, rtol=0.0, row_rtol=0.0) -> float:
        """Record whether |got - want| is within the limit everywhere and
        every value is finite; return the largest |got - want|."""
        max_err, bad, mean_want, worst = self.compare(got, want, atol, rtol, row_rtol)
        finite = bool(self.torch.isfinite(got).all().item())
        ok = bad == 0 and finite and got.shape == want.shape
        row = f" row_rtol={row_rtol:g} worst_err/limit={worst:.3f}" if row_rtol else ""
        print(f"check {label}: max_abs_err={max_err:.3e} atol={atol:.3e} "
              f"rtol={rtol:g}{row} mean_abs_want={mean_want:.3e} "
              f"{'ok' if ok else f'FAIL ({bad} out of tolerance, finite={finite})'}")
        if not ok:
            self.failures.append(label)
        return max_err

    def expect_caught(self, label, fault, want, atol, rtol, row_rtol=0.0):
        """Record whether the limit rejects ``fault``, the plain output of a
        deliberately wrong computation, against ``want``."""
        max_err, bad, _, _ = self.compare(fault, want, atol, rtol, row_rtol)
        print(f"check {label}: {bad} of {want.numel()} elements out of tolerance "
              f"(max_abs_err={max_err:.3e}) {'ok' if bad else 'FAIL (not caught)'}")
        if not bad:
            self.failures.append(label)

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
    def bound(nbytes: float, ops: float, peak_flops: float) -> tuple[float, str]:
        by_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        by_ops = ops / peak_flops * 1e3
        return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")

    def record(self, name, *, launches, max_err, ms, plain_ms, library_ms,
               nbytes, ops, shape, tol, peak_flops=PEAK_FP32_FLOPS, append=True,
               **extra) -> dict:
        bound_ms, bound_by = self.bound(nbytes, ops, peak_flops)
        peak = self.torch.cuda.max_memory_allocated()
        share = bound_ms / ms
        source, replaces = SOURCES[name]
        lib = "null" if library_ms is None else f"{library_ms:.3f}"
        print(f"kernel {name} {shape}: kernel_ms={ms:.3f} plain_ms={plain_ms:.3f} "
              f"library_ms={lib} bound_ms={bound_ms:.3f} ({bound_by}; published "
              f"H100 SXM peaks at 700 W, this card's limit {self.power_limit}) "
              f"share_of_bound={share:.3f} max_memory_allocated={peak} "
              f"launches={launches}")
        row = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": max_err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms, "share": share,
            "shape": list(shape), "tolerance": tol,
            "max_memory_allocated": peak, **extra}
        if append:
            self.rows.append(row)
        return row

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
        self.card = smi.splitlines()[0].strip()
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
            lines = log.read_text().splitlines()
            for line in lines:
                if any(w in line for w in ("Compiling entry", "Used", "spill", "wgmma")):
                    print(f"  ptxas: {line.split('ptxas info    :')[-1].strip()}")
            self.paged_ptxas(lines)

    @staticmethod
    def paged_ptxas(lines):
        """The bf16 paged kernel's registers and spills, per instance."""
        name, spill = None, ""
        for line in lines:
            if "Compiling entry" in line:
                entry = re.search(r"paged_tc_kernelILi(\d+)ELi(\d+)E", line)
                name = entry and f"Dh={entry[1]} n8 tiles={entry[2]}"
            elif name and "spill" in line:
                spill = line.strip()
            elif name and "Used" in line:
                print(f"paged bf16 kernel {name}: {line.split(':', 1)[-1].strip()}; {spill}")
                name = None

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

        # the last two take the fp32 kernel's K in 2 and 3 panels, the last
        # one short
        for m, kk, n in ((8, 16, 8), (300, 700, 250), (256, 512, 128), (200, 8300, 150),
                         (136, 17000, 260)):
            for dtype, atol in ((torch.float32, 1e-3), (torch.bfloat16, 0.15)):
                a, b = self.rand((m, kk), dtype=dtype), self.rand((kk, n), dtype=dtype)
                self.check(f"matmul {m}x{kk}x{n} {dtype}", k.matmul(a, b),
                           k.matmul(a, b, use_kernel=False), atol * math.sqrt(kk), 1e-2)
        self.expect_raise("matmul rejects a transposed view",
                          lambda: k.matmul(a.t(), a), ValueError)
        self.split_check()

        coef = torch.tensor([0.5, 0.1, 0.05, 0.02, 0.01], device=DEVICE)
        # the last three cut the kernel's 16 x 64 tile and its ring of z
        # planes: X not a multiple of 4, Y and X below the halo, X one past
        # a tile
        for shape in ((8, 16, 128), (16, 24, 136), (24, 8, 256), (5, 3, 40),
                      (7, 19, 1001), (9, 5, 3), (3, 70, 65)):
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

    def split_check(self):
        """The SGEMM's split pre-pass bit for bit against its plain version,
        at the 300 x 700 x 250 test shape: A as it is and B transposed, each
        zero-padded to the kernel's tile multiples."""
        torch = self.torch
        from repro_torch.kernels.streamed_matmul.kernel import split_tf32_cuda
        from repro_torch.kernels.streamed_matmul.ref import split_tf32_ref

        a, b = self.rand((300, 700)), self.rand((700, 250))
        for name, x, src, transpose in (("A", a, a, False), ("B^T", b, b.t(), True)):
            rows, cols = -(-src.shape[0] // 128) * 128, -(-src.shape[1] // 32) * 32
            hi, lo = split_tf32_cuda(x, transpose=transpose, rows=rows, cols=cols)
            for got, want in zip((hi, lo), split_tf32_ref(src)):
                full = torch.zeros((rows, cols), device=DEVICE)
                full[:src.shape[0], :src.shape[1]] = want
                got_bits, want_bits = got.view(torch.int32), full.view(torch.int32)
                self.expect(f"matmul split of {name} {tuple(src.shape)} -> ({rows}, {cols}) "
                            f"equals split_tf32_ref bit for bit "
                            f"({int((got_bits != want_bits).sum())} differ)",
                            bool(torch.equal(got_bits, want_bits)))

    def gemm_fp64_check(self, a, b, c, c_lib) -> dict:
        """The kernel's c against fp64 on GEMM_FP64_ROWS rows, at
        GEMM_FP64_FACTOR times the largest error of torch.matmul in fp32
        (``c_lib``) on the same rows; then a one-pass TF32 product of those
        rows (TF32 allowed for that call alone; the port never makes it)
        must fail the same limit."""
        torch = self.torch
        n = a.shape[0]
        last = (n - 1) // 128 * 128  # the last 128-row tile
        g = torch.Generator(device=DEVICE).manual_seed(3)
        others = torch.randperm(last, generator=g, device=DEVICE)[:GEMM_FP64_ROWS - (n - last)]
        rows = torch.cat([others.sort().values, torch.arange(last, n, device=DEVICE)])
        a64 = a[rows].double()
        want = torch.empty((rows.numel(), b.shape[1]), dtype=torch.float64, device=DEVICE)
        for j in range(0, b.shape[1], GEMM_FP64_COLS):
            want[:, j:j + GEMM_FP64_COLS] = a64 @ b[:, j:j + GEMM_FP64_COLS].double()
        del a64

        def err(x):
            return (x.double() - want).abs_().max().item()

        e_kernel, e_lib = err(c[rows]), err(c_lib[rows])
        limit = GEMM_FP64_FACTOR * e_lib
        self.expect(f"cublas c vs fp64 on {rows.numel()} rows (rows {last}..{n - 1} "
                    f"included): kernel {e_kernel:.3e} <= {GEMM_FP64_FACTOR:g} x "
                    f"torch.matmul fp32 {e_lib:.3e}", e_kernel <= limit)
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            one_pass = torch.matmul(a[rows], b)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        e_tf32 = err(one_pass)
        self.expect(f"the fp64 limit catches a one-pass TF32 product ({e_tf32:.3e} > "
                    f"{limit:.3e})", e_tf32 > limit)
        return {"fp64_rows": rows.numel(), "fp64_max_err": e_kernel,
                "fp64_max_err_torch_matmul": e_lib, "fp64_max_err_tf32_one_pass": e_tf32,
                "fp64_limit": limit}

    def conv3d_ms(self, grid, coeffs, want) -> tuple[float | None, str]:
        """Time of one nn.Conv3d that computes the stencil step (the 25-tap
        star as a 9^3 weight, replicate padding, fp32 with TF32 off), which
        the port never calls; its output is held against ``want``, the
        kernel's step, at 1e-3.  None with cuDNN's error if it refuses."""
        torch = self.torch
        r = len(coeffs) - 1
        conv = torch.nn.Conv3d(1, 1, 2 * r + 1, padding=r, padding_mode="replicate",
                               bias=False).to(DEVICE)
        with torch.inference_mode():
            w = torch.zeros_like(conv.weight)
            w[0, 0, r, r, r] = coeffs[0]
            for i in range(1, r + 1):
                for d in (-i, i):
                    w[0, 0, r + d, r, r] = w[0, 0, r, r + d, r] = w[0, 0, r, r, r + d] = coeffs[i]
            conv.weight.copy_(w)
            x = grid[None, None]
            note = ("nn.Conv3d(1, 1, 9, padding=4, padding_mode='replicate', bias=False), "
                    "25-tap star weight, fp32, TF32 off")
            try:
                self.check("fdtd3d step: nn.Conv3d vs kernel", conv(x)[0, 0], want, 1e-3)
                self.free()
                return self.time_ms(lambda: conv(x), reps=1), note
            except RuntimeError as e:  # cuDNN does not take the full grid
                msg = str(e).splitlines()[0][:200]
                print(f"fdtd3d nn.Conv3d refused: {msg}")
                return None, f"null: {note} refused: {msg}"

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
        # c_ref is the plain version: torch.matmul in fp32, TF32 off
        fp64 = self.gemm_fp64_check(out["a"], out["b"], out["c"], out["c_ref"])
        a, b = out["a"], out["b"]
        del out
        self.free()
        # the phase's peak so far (the checks' temporaries); then the
        # kernel's own: a, b, one c and the split scratch
        checks_peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ms = self.time_ms(lambda: k.matmul(a, b))
        call_peak = torch.cuda.max_memory_allocated()
        plain = self.time_ms(lambda: k.matmul(a, b, use_kernel=False))
        library = self.time_ms(lambda: torch.matmul(a, b))
        # The bound: the function's 2n^3 operations at the fastest peak that
        # takes fp32 operands (TF32).  Beside it, the ceilings of two
        # algorithms: the kernel's 3xTF32 (three TF32 products) and the
        # earlier kernel's fp32 FMAs on the CUDA cores.
        self.record("matmul", launches=launches, max_err=err, ms=ms,
                    plain_ms=plain, library_ms=library, nbytes=3 * 4 * n * n,
                    ops=2 * n**3, peak_flops=PEAK_TF32_FLOPS, shape=(n, n, n),
                    tol=[atol, 1e-2],
                    tf32x3_ceiling_ms=3 * 2 * n**3 / PEAK_TF32_FLOPS * 1e3,
                    fp32_cuda_core_ceiling_ms=2 * n**3 / PEAK_FP32_FLOPS * 1e3,
                    max_memory_allocated_kernel_call=call_peak,
                    max_memory_allocated_checks=checks_peak, **fp64)
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
        library, note = self.conv3d_ms(grid, coeffs, k.fdtd3d_step(grid, coeffs))
        self.record("fdtd3d", launches=launches, max_err=err, ms=ms,
                    plain_ms=plain, library_ms=library, nbytes=8 * cells + 4 * 5,
                    ops=FDTD_OPS_PER_CELL * cells, shape=FDTD_SHAPE, tol=1e-3,
                    library_note=note)
        del grid, coeffs
        self.free()

    # -- attention -------------------------------------------------------

    def attention_checks(self):
        """Flash and paged attention against their plain versions at the
        kernel tests' shapes (tests/test_kernels.py:84-148), plus ragged and
        cross lengths, Dh=128, a permuted block table and a zero length."""
        torch, k = self.torch, self.kernels
        print("== attention kernel checks at test shapes")
        tols = ((torch.float32, 2e-3, 0.0), (torch.bfloat16, BF16_ATOL, BF16_RTOL))
        for hq, hkv in ((4, 4), (4, 2), (8, 1)):
            for window in (None, 64):
                for dtype, atol, rtol in tols:
                    q = self.rand((2, 256, hq, 32), dtype=dtype)
                    kk, v = (self.rand((2, 256, hkv, 32), dtype=dtype) for _ in range(2))
                    self.check(f"flash hq={hq} hkv={hkv} window={window} {dtype}",
                               k.flash_attention(q, kk, v, window=window),
                               k.flash_attention(q, kk, v, window=window, use_kernel=False),
                               atol, rtol)
        for sq, skv, hq, hkv, dh, window, causal in (
                (128, 256, 4, 2, 32, None, True), (100, 256, 4, 2, 32, None, True),
                (77, 200, 4, 2, 32, 64, True), (1, 300, 8, 2, 64, None, True),
                (300, 300, 4, 2, 16, None, False), (200, 200, 28, 4, 128, None, True),
                (200, 200, 48, 8, 128, 50, True)):
            for dtype, atol, rtol in tols:
                q = self.rand((1, sq, hq, dh), dtype=dtype)
                kk, v = (self.rand((1, skv, hkv, dh), dtype=dtype) for _ in range(2))
                kw = dict(causal=causal, window=window)
                self.check(f"flash Sq={sq} Skv={skv} hq={hq} hkv={hkv} Dh={dh} "
                           f"window={window} causal={causal} {dtype}",
                           k.flash_attention(q, kk, v, **kw),
                           k.flash_attention(q, kk, v, use_kernel=False, **kw), atol, rtol)
        self.expect_raise("flash rejects Dh=48",
                          lambda: k.flash_attention(*(self.rand((1, 8, 2, 48)),) * 3),
                          ValueError)

        # the kernel tests' shapes; then the bf16 kernel's other template
        # instances (Dh 16 and 64; G 1, 3 and up to 16, two n8 tiles of
        # heads), page sizes that are not a multiple of 8 (5, 12), of 24 and
        # of two stages a page (128), and a row over two chunks (3,200
        # positions); then PAGED_SHORT_CASES, short rows in every instance.
        # bf16 is also held against the plain version run in fp32 on the
        # same values at FULL_ATOL/FULL_RTOL, which a single bf16 P fails.
        cases = [(psz, pages, hq, hkv, dh, None) for psz, pages in ((16, 4), (32, 8))
                 for hq, hkv, dh in ((8, 2, 32), (64, 8, 128))]
        cases += [(psz, pages, hq, hkv, dh, None) for psz, pages, hq, hkv, dh in (
            (16, 4, 4, 2, 16), (32, 3, 16, 2, 64), (32, 4, 4, 4, 64), (16, 4, 6, 2, 32),
            (16, 4, 32, 2, 16), (32, 2, 32, 2, 32), (64, 2, 32, 2, 64), (32, 8, 32, 2, 128),
            (12, 6, 8, 2, 32), (5, 9, 64, 8, 128), (24, 5, 16, 4, 64), (128, 3, 64, 8, 128),
            (16, 200, 8, 2, 32))]
        cases += [(*case, PAGED_SHORT_LENS) for case in PAGED_SHORT_CASES]
        for psz, pages, hq, hkv, dh, lens in cases:
            for dtype, atol, rtol in tols:
                B = 3
                npages = pages * B + 2
                kp, vp = (self.rand((npages, psz, hkv, dh), dtype=dtype) for _ in range(2))
                q = self.rand((B, hq, dh), dtype=dtype)
                bt = torch.randperm(npages, device=DEVICE)[:B * pages].reshape(
                    B, pages).to(torch.int32)
                sl = torch.tensor(lens or (psz * pages, psz * pages - 5, 3),
                                  dtype=torch.int32, device=DEVICE)
                label = f"paged psz={psz} pages={pages} hq={hq} hkv={hkv} Dh={dh}"
                got = k.paged_attention(q, kp, vp, bt, sl)
                self.check(f"{label} {dtype}", got,
                           k.paged_attention(q, kp, vp, bt, sl, use_kernel=False),
                           atol, rtol)
                if dtype == torch.bfloat16:
                    self.check(f"{label} lengths {sl.tolist()} bf16 vs fp32 plain", got,
                               k.paged_attention(q.float(), kp.float(), vp.float(), bt, sl,
                                                 use_kernel=False),
                               FULL_ATOL, FULL_RTOL)
        B, hq, hkv, dh, psz, pages = 2, 4, 2, 16, 8, 4
        npages = B * pages
        kp, vp = (self.rand((npages, psz, hkv, dh)) for _ in range(2))
        q = self.rand((B, hq, dh))
        bt = torch.arange(npages, dtype=torch.int32, device=DEVICE).reshape(B, pages)
        sl = torch.tensor([psz * pages, psz * pages - 3], dtype=torch.int32, device=DEVICE)
        out1 = k.paged_attention(q, kp, vp, bt, sl)
        for trial in range(5):
            perm = torch.randperm(npages, device=DEVICE)
            inv = torch.argsort(perm).to(torch.int32)
            self.check(f"paged block-table permutation {trial}", out1,
                       k.paged_attention(q, kp[perm], vp[perm], inv[bt.long()], sl), 1e-4)
        sl0 = torch.tensor([0, 17], dtype=torch.int32, device=DEVICE)
        out = k.paged_attention(q, kp, vp, bt, sl0)
        self.check("paged zero-length sequence gives zeros", out[0],
                   torch.zeros_like(out[0]), 0.0)
        self.check("paged ragged length", out,
                   k.paged_attention(q, kp, vp, bt, sl0, use_kernel=False), 2e-3)
        self.expect_raise("paged rejects an int64 block table",
                          lambda: k.paged_attention(q, kp, vp, bt.long(), sl), TypeError)
        torch.cuda.synchronize()

    def paged_plain(self, q, kp, vp, bt, sl, widen=False):
        """The plain paged version in groups of PAGED_CHECK_GROUP sequences:
        the whole batch at once would need a ~137 GB gathered fp32 copy.
        With ``widen``, each group's pages are gathered and widened to fp32,
        with its q, and read through an identity block table (the whole
        pool in fp32 would not fit beside the bf16 one)."""
        torch, k = self.torch, self.kernels
        outs = []
        for i in range(0, q.shape[0], PAGED_CHECK_GROUP):
            qg, ktab, vtab, btg = (q[i:i + PAGED_CHECK_GROUP], kp, vp,
                                   bt[i:i + PAGED_CHECK_GROUP])
            if widen:
                idx = btg.flatten().long()
                qg, ktab, vtab = qg.float(), kp[idx].float(), vp[idx].float()
                btg = torch.arange(idx.numel(), dtype=torch.int32,
                                   device=DEVICE).reshape(btg.shape)
            outs.append(k.paged_attention(qg, ktab, vtab, btg,
                                          sl[i:i + PAGED_CHECK_GROUP], use_kernel=False))
            del qg, ktab, vtab
        return torch.cat(outs)

    def paged_path(self, paged_decode):
        """The paged-decode demo at qwen2-72b / decode_32k width."""
        torch, k = self.torch, self.kernels
        from repro_torch.kernels.paged_attention.kernel import paged_attention_cuda
        self.start_app(f"paged_decode {PAGED_MODEL} B={PAGED_B} pages={PAGED_PAGES} "
                       f"psz={PAGED_PSZ} bf16")
        res = paged_decode(PAGED_MODEL, batch=PAGED_B, pages=PAGED_PAGES,
                           page_size=PAGED_PSZ, dtype=torch.bfloat16, device=DEVICE)
        torch.cuda.synchronize()
        launches = self.launched("paged_attention")
        q, kp, vp, bt, sl = (res[n] for n in ("q", "k_pool", "v_pool", "block_table",
                                                "seq_lens"))
        pool_bytes = 2 * kp.numel() * kp.element_size()
        print(f"paged pools: {pool_bytes} bytes of K and V, lengths "
              f"{sorted(set(sl.tolist()))}")
        want = self.paged_plain(q, kp, vp, bt, sl, widen=True)
        err = self.check("paged_decode out (full width) vs fp32 plain", res["out"], want,
                         FULL_ATOL, FULL_RTOL)
        del res
        self.free()
        self.expect_caught("the limit catches each sequence one page short",
                           self.paged_plain(q, kp, vp, bt, (sl - PAGED_PSZ).clamp_min(0),
                                            widen=True),
                           want, FULL_ATOL, FULL_RTOL)
        del want
        self.free()

        # the kernel again, over a random permutation of the pool's pages,
        # with random lengths in [0, 32768] (one 0, one full row)
        g = torch.Generator(device=DEVICE).manual_seed(1)
        npages, span = kp.shape[0], PAGED_PAGES * PAGED_PSZ
        bt_perm = torch.randperm(npages, generator=g, device=DEVICE).to(
            torch.int32).reshape(PAGED_B, PAGED_PAGES)
        sl_rand = torch.randint(0, span + 1, (PAGED_B,), generator=g, device=DEVICE,
                                dtype=torch.int32)
        sl_rand[0], sl_rand[1] = 0, span
        out = k.paged_attention(q, kp, vp, bt_perm, sl_rand)
        err = max(err, self.check("paged permuted block table, random lengths vs fp32 plain",
                                  out, self.paged_plain(q, kp, vp, bt_perm, sl_rand,
                                                        widen=True),
                                  FULL_ATOL, FULL_RTOL))
        self.check("paged zero-length row gives zeros (full width)", out[0],
                   torch.zeros_like(out[0]), 0.0)
        del out
        self.free()

        # short rows and the edges of stages and chunks, cycled over the batch
        sl_edge = torch.tensor([PAGED_EDGE_LENS[i % len(PAGED_EDGE_LENS)]
                                for i in range(PAGED_B)], dtype=torch.int32, device=DEVICE)
        out = k.paged_attention(q, kp, vp, bt, sl_edge)
        err = max(err, self.check(
            f"paged lengths cycling over {PAGED_EDGE_LENS} vs fp32 plain", out,
            self.paged_plain(q, kp, vp, bt, sl_edge, widen=True), FULL_ATOL, FULL_RTOL))
        del out
        self.free()

        # the same inputs give the same bits: the partials merge in chunk
        # order; the launches and the scratch of one call
        k.paged_attention.launches = 0
        paged_attention_cuda.scratch_bytes = 0
        first = k.paged_attention(q, kp, vp, bt, sl)
        per_call = k.paged_attention.launches
        scratch_bytes = paged_attention_cuda.scratch_bytes
        self.expect("paged: two calls on the same inputs give the same bits",
                    bool(torch.equal(first.view(torch.int16),
                                     k.paged_attention(q, kp, vp, bt, sl).view(torch.int16))))
        del first
        self.free()

        # time the demo's call; the bound counts the live rows only
        hq, hkv, dh = q.shape[1], kp.shape[2], kp.shape[3]
        live = int(sl.clamp(0, span).sum().item())
        pages_read = int(((sl.clamp(0, span) + PAGED_PSZ - 1) // PAGED_PSZ).sum().item())
        nbytes = (2 * live * hkv * dh * 2      # K and V rows, bf16
                  + 2 * 2 * q.numel()          # q in, out back
                  + 4 * pages_read + 4 * PAGED_B)
        ms = self.time_ms(lambda: k.paged_attention(q, kp, vp, bt, sl))
        plain = self.time_ms(lambda: self.paged_plain(q, kp, vp, bt, sl), reps=1)
        # the rate a device-to-device copy reaches on this card, as a
        # yardstick of what a bytes-bound kernel can read: a quarter of the
        # K pool copied by torch's copy_, its bytes read and written once
        src = kp[:kp.shape[0] // 4]
        dst = torch.empty_like(src)
        copy_rate = 2 * src.numel() * src.element_size() / (
            self.time_ms(lambda: dst.copy_(src)) / 1e3)
        del src, dst
        print(f"paged: {nbytes / (ms / 1e3):.4e} bytes/s read by the kernel, "
              f"{copy_rate:.4e} bytes/s moved by a device copy")
        self.record("paged_attention", launches=launches, max_err=err, ms=ms,
                    plain_ms=plain, library_ms=None, nbytes=nbytes,
                    ops=4 * hq * dh * live, peak_flops=PEAK_BF16_FLOPS,
                    shape=(PAGED_B, hq, hkv, dh, PAGED_PAGES, PAGED_PSZ),
                    tol=[FULL_ATOL, FULL_RTOL], pool_bytes=pool_bytes,
                    live_positions=live, launches_per_call=per_call,
                    device_copy_bytes_per_s=copy_rate,
                    scratch_bytes=scratch_bytes,
                    library_note="null: no single PyTorch call attends through a "
                                 "block table without a gathered copy of the pool")
        del q, kp, vp, bt, sl, bt_perm, sl_rand, sl_edge
        self.free()

    def flash_path(self, get_config, attention):
        """bf16 flash prefill at S=32,768 for qwen2-7b (causal) and
        mixtral-8x22b (sliding window)."""
        torch, k = self.torch, self.kernels
        attention_flash = attention.attention_flash
        g = torch.Generator(device=DEVICE).manual_seed(2)
        inputs = []
        for model, window in FLASH_CASES:
            cfg = get_config(model).model
            assert cfg.sliding_window == window, (model, cfg.sliding_window)
            hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
            inputs.append([torch.randn((1, FLASH_S, h, dh), generator=g, device=DEVICE,
                                       dtype=torch.bfloat16) for h in (hq, hkv, hkv)])
        self.start_app(f"flash_attention prefill S={FLASH_S} bf16: "
                       + ", ".join(f"{m} window={w}" for m, w in FLASH_CASES))
        outs = [k.flash_attention(q, kk, v, window=window)
                for (q, kk, v), (_, window) in zip(inputs, FLASH_CASES)]
        torch.cuda.synchronize()
        launches = self.launched("flash_attention")

        rows = []
        tol = (FLASH_FULL_ATOL, FLASH_FULL_RTOL, FLASH_FULL_ROW_RTOL)
        for (q, kk, v), out, (model, window) in zip(inputs, outs, FLASH_CASES):
            hq, dh = q.shape[2], q.shape[3]
            wide = [x.float() for x in (q, kk, v)]
            want = attention_flash(*wide, window=window, block=FLASH_CHECK_BLOCK)
            err = self.check(f"flash {model} window={window} (full width) vs fp32 "
                             "attention_flash", out, want, *tol)
            # faults of one KV tile: the diagonal moved a tile left, or the
            # window a tile short; and V of the wrong tile at S/2
            fault = ({"q_offset": -FAULT_TILE} if window is None
                     else {"window": window - FAULT_TILE})
            self.expect_caught(f"the limit catches {model} with {fault}",
                               attention_flash(*wide, block=FLASH_CHECK_BLOCK,
                                               **{"window": window, **fault}),
                               want, *tol)
            self.expect_caught(f"the limit catches {model} with the wrong V tile at S/2",
                               attention_flash(wide[0], wide[1], wrong_v_tile(wide[2]),
                                               window=window, block=FLASH_CHECK_BLOCK),
                               want, *tol)
            del wide, want
            self.free()
            i = torch.arange(FLASH_S, dtype=torch.float64)
            pairs = int((i + 1).clamp(max=window or FLASH_S).sum().item())
            nbytes = 2 * (2 * q.numel() + 2 * kk.numel())
            ms = self.time_ms(lambda: k.flash_attention(q, kk, v, window=window))
            plain = self.time_ms(lambda: attention_flash(q, kk, v, window=window,
                                                         block=FLASH_CHECK_BLOCK), reps=1)
            library, note = self.sdpa_ms(q, kk, v, window, attention.causal_mask)
            rows.append(self.record(
                "flash_attention", launches=launches, max_err=err, ms=ms,
                plain_ms=plain, library_ms=library, nbytes=nbytes,
                ops=4 * hq * dh * pairs, peak_flops=PEAK_BF16_FLOPS,
                shape=(1, FLASH_S, hq, kk.shape[2], dh), tol=list(tol),
                append=False, model=model, window=window, pairs_in_band=pairs,
                library_note=note))
            self.free()
        del inputs, outs
        self.free()
        self.rows.append({**rows[0], "window_case": rows[1]})

    def sdpa_ms(self, q, k, v, window, causal_mask) -> tuple[float, str]:
        """Time of one scaled_dot_product_attention call (GQA) on the same
        inputs in its (B, H, S, D) layout: each fused backend that takes
        the case is timed on its own, and the fastest is returned with its
        name (the math backend would build an S x S score tensor).  The
        transposed copies and, for a window, the additive band mask (0 in
        the band, -inf outside, in the inputs' dtype: 2 GB at S = 32k in
        bf16) are made outside the timing."""
        torch = self.torch
        from torch.nn.attention import SDPBackend, sdpa_kernel

        F = torch.nn.functional
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        if window is None:
            kw, note = {"is_causal": True}, "is_causal=True"
        else:
            band = causal_mask(FLASH_S, FLASH_S, window=window, device=DEVICE)
            kw = {"attn_mask": torch.zeros(band.shape, dtype=q.dtype, device=DEVICE)
                  .masked_fill_(~band, float("-inf"))}
            note = f"attn_mask=additive {q.dtype} band of {FLASH_S} x {FLASH_S}"
            del band
        times = {}
        for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                        SDPBackend.EFFICIENT_ATTENTION):
            try:
                with sdpa_kernel([backend]):
                    times[backend.name] = self.time_ms(lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, enable_gqa=True, **kw))
            except RuntimeError as e:  # the backend does not take this case
                print(f"sdpa {backend.name} ({note}): refused: {str(e).splitlines()[0][:120]}")
                continue
            print(f"sdpa {backend.name} ({note}): {times[backend.name]:.3f} ms")
        if not times:
            self.failures.append(f"no fused SDPA backend takes {note}")
            return None, f"null: no fused scaled_dot_product_attention backend takes {note}"
        best = min(times, key=times.get)
        return times[best], (f"scaled_dot_product_attention({note}, enable_gqa=True), "
                             f"{best} backend, the fastest of "
                             + ", ".join(f"{n} {t:.3f} ms" for n, t in times.items()))

    # -- the serving path and the movement layer --------------------------

    def serve_path(self, tf, init_params, init_caches):
        """``launch.serve.serve`` on qwen2-7b at full width and depth in
        bf16, its prompts from ``data.pipeline.prefetched`` (depth 2); then
        a profiled prefill and decode steps of the same shapes."""
        torch = self.torch
        from repro_torch.configs import ShapeConfig, get_config
        from repro_torch.data.pipeline import prefetched
        from repro_torch.launch.serve import serve

        cfg = get_config(SERVE_MODEL).model
        self.start_app(f"serve {SERVE_MODEL} full width B={SERVE_B} prompt={SERVE_PROMPT} "
                       f"gen={SERVE_GEN} {cfg.dtype}")
        prompts = prefetched(cfg, ShapeConfig("serve", SERVE_PROMPT, SERVE_B, "prefill"),
                             device=DEVICE, depth=2)
        rec = {}
        with GraphHeld(self, tf) as held, PrefillHeld(self, tf) as held_prefill:
            toks = serve(SERVE_MODEL, reduced=False, batch=SERVE_B, prompt_len=SERVE_PROMPT,
                         gen=SERVE_GEN, device=DEVICE, prompts=prompts, record=rec,
                         keep_logits=True)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
            counts = {name: fn.launches for name, fn in self.counters.items()}
            graph = held.check("serve", toks, rec)
            prefill_graph = held_prefill.check("serve", rec)
        self.serve_output("serve", cfg, toks, rec.pop("logits"))
        del prompts
        self.free()
        # bounds: the layers' matrix weights for every prompt token, the
        # head for the last position, and causal attention (QK^T and PV);
        # a decode step reads every weight but the embedding table once,
        # the embedding rows of its tokens and the live K/V rows
        L, d, V = cfg.num_layers, cfg.d_model, cfg.padded_vocab
        mats = L * (cfg.attn_params_per_layer() + cfg.ffn_params_per_layer())
        pairs = SERVE_PROMPT * (SERVE_PROMPT + 1) // 2
        prefill_flops = (2 * mats * SERVE_B * SERVE_PROMPT + 2 * d * V * SERVE_B
                         + 4 * cfg.num_heads * cfg.head_dim * pairs * L * SERVE_B)
        prefill_bound = prefill_flops / PEAK_BF16_FLOPS * 1e3
        weight_bytes = 2 * (L * cfg.params_per_layer() + V * d + d + SERVE_B * d)
        mean_live = SERVE_PROMPT + SERVE_GEN / 2  # positions attended, over the steps
        kv_bytes = 2 * 2 * L * SERVE_B * mean_live * cfg.num_kv_heads * cfg.head_dim
        decode_bound = (weight_bytes + kv_bytes) / PEAK_BYTES_PER_S * 1e3
        out = {"model": SERVE_MODEL, "batch": SERVE_B, "prompt_len": SERVE_PROMPT,
               "gen": SERVE_GEN, "dtype": cfg.dtype, "params": cfg.total_params(),
               **rec, "max_memory_allocated": peak,
               "prefill_flops": prefill_flops, "prefill_bound_ms": prefill_bound,
               "prefill_share": prefill_bound / rec["prefill_ms"],
               "decode_bytes": weight_bytes + kv_bytes, "decode_bound_ms": decode_bound,
               "decode_share": decode_bound / rec["decode_ms_per_token"],
               "graph": graph, "prefill_graph": prefill_graph, "kernel_launches": counts,
               "card": self.card, "power_limit": self.power_limit}
        print(f"serve: prefill {rec['prefill_ms']:.1f} ms (bound {prefill_bound:.1f} ms), "
              f"decode {rec['decode_ms_per_token']:.2f} ms/token as a CUDA graph, "
              f"{graph['eager_ms_per_token']:.2f} eager (bound {decode_bound:.2f} ms), capture "
              f"{rec['capture_ms']:.1f} ms, {rec['tokens_per_s']:.1f} tokens/s, peak {peak} "
              f"bytes; the decode attention runs in the paged kernel, kernel launches {counts}")
        out["profile"] = self.serve_profile(tf, init_params, init_caches)
        print(json.dumps({"serve_path": out}))

    def decode_route(self, tf, init_params):
        """qwen2-7b's decode through the paged kernel at full depth, at each
        of ROUTE_CASES' shapes (``decode_route_case``)."""
        from repro_torch.configs import get_config

        arch = get_config(SERVE_MODEL)
        out = {label: self.decode_route_case(tf, init_params, arch, B, P, G)
               for label, B, P, G in ROUTE_CASES}
        print(json.dumps({"decode_route": out}))

    def decode_route_case(self, tf, init_params, arch, B, P, G) -> dict:
        """qwen2-7b's decode through the paged kernel at full depth, B
        sequences of a P-token prompt and G tokens (a cache of S = P + G).
        First each of layers 0 and L - 1 alone (``route_layer_check``).
        Then the serve step of ``launch.step.build_serve_step`` captured with
        the route (each layer's attention in the paged kernel) and with the
        plain route (``plain_route``), each on its own copy of the same
        post-prefill caches and fed the same tokens.  Checks: the capture
        counts ``attn.decode_kernel`` once a layer (the plain one
        ``attn.decode_plain``) and launches ROUTE_LAUNCHES paged kernels a
        layer for each step it runs (warm-up and capture; an eager step the
        same, a replay none); the route's logits within BF16_LOGIT_REL of
        the plain route's, per step and row, and at least
        ROUTE_TOKENS_ALIKE of their next tokens alike; its replays bit for
        bit its eager ``decode_step``s.  Times: ms a token both ways (a
        replay and the host's read of the tokens), and the paged kernels'
        device time a layer in a profiled replay beside the bytes of the
        live K/V."""
        torch = self.torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        from repro_torch import spans
        from repro_torch.launch.serve import rehome_caches
        from repro_torch.launch.step import GRAPH_WARMUP, build_serve_step

        cfg = arch.model
        L, S, V = cfg.num_layers, P + G, cfg.vocab_size
        label = f"decode route B={B} S={S}"
        paged = self.counters["paged_attention"]
        self.start_app(f"decode route {SERVE_MODEL} full depth B={B} prompt={P} gen={G} "
                       f"{cfg.dtype}, pages of {tf.page_size(S)}")
        g = torch.Generator(device=DEVICE).manual_seed(30)
        params = init_params(cfg, g, DEVICE)
        prompt = torch.randint(0, cfg.vocab_size, (B, P), generator=g, device=DEVICE)
        logits, caches = tf.prefill(params, {"tokens": prompt}, cfg)
        first = logits.argmax(dim=-1).to(torch.int32)
        pristine = rehome_caches(cfg, caches, B, S, DEVICE)
        del logits, caches, prompt
        layer_check = self.route_layer_check(tf, cfg, pristine, (0, L - 1), P, g, label)
        lens = [torch.tensor(P + i, dtype=torch.int32, device=DEVICE) for i in range(G - 1)]

        def served(kernel: bool, fed=None) -> dict:
            """G - 1 replays of a serve step captured on this route, greedy
            from the prefill's tokens, or fed ``fed``."""
            own = {k: v.clone() for k, v in pristine.items()}
            step = build_serve_step(arch, device=DEVICE)
            paged.launches = 0
            with contextlib.nullcontext() if kernel else plain_route(tf):
                with spans.recording() as rec:
                    step.capture(params, {"tokens": first}, own, lens[0])
            counts = {s.name: s.counts for s in rec.spans if s.counts}
            launches = paged.launches
            inputs, out, nxt = [], [], first
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i, n in enumerate(lens):
                inputs.append(nxt if fed is None else fed[i])
                nxt, _ = step(params, {"tokens": inputs[-1]}, own, n)
                out.append(step.logits.clone())
                nxt = nxt.to(torch.int32)
                nxt.cpu()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / len(lens)
            return {"step": step, "caches": own, "logits": out, "inputs": inputs,
                    "ms": ms, "counts": counts, "launches": launches}

        route = served(True)
        plain = served(False, route["inputs"])
        per_step = L * ROUTE_LAUNCHES
        self.expect(f"{label}: the capture counts attn.decode_kernel {L} times (once a "
                    f"layer) and the warm-up {GRAPH_WARMUP * L}: {route['counts']}",
                    route["counts"] == {"graph.warmup": {"attn.decode_kernel": GRAPH_WARMUP * L},
                                        "graph.capture": {"attn.decode_kernel": L}})
        self.expect(f"{label}: the warm-up and capture launch {route['launches']} paged "
                    f"kernels, {per_step} a step",
                    route["launches"] == per_step * (GRAPH_WARMUP + 1))
        self.expect(f"{label}: the plain route counts attn.decode_plain and launches no "
                    f"paged kernel: {plain['counts']}, {plain['launches']}",
                    plain["counts"] == {"graph.warmup": {"attn.decode_plain": GRAPH_WARMUP * L},
                                        "graph.capture": {"attn.decode_plain": L}}
                    and plain["launches"] == 0)
        rel = max(((a[:, :V].float() - b[:, :V].float()).norm(dim=-1)
                   / b[:, :V].float().norm(dim=-1)).max().item()
                  for a, b in zip(route["logits"], plain["logits"]))
        agree = sum(int((a[:, :V].argmax(dim=-1) == b[:, :V].argmax(dim=-1)).sum())
                    for a, b in zip(route["logits"], plain["logits"])) / (B * len(lens))
        self.expect(f"{label}: logits within {BF16_LOGIT_REL} of the plain route's "
                    f"(worst rel L2 {rel:.4e})", rel <= BF16_LOGIT_REL)
        self.expect(f"{label}: next tokens alike the plain route's {agree:.4f} "
                    f"(at least {ROUTE_TOKENS_ALIKE})", agree >= ROUTE_TOKENS_ALIKE)
        plain_ms = plain["ms"]
        del plain
        self.free()
        eager = {k: v.clone() for k, v in pristine.items()}
        differ = 0
        for i, n in enumerate(lens):
            paged.launches = 0
            logits, _ = tf.decode_step(params, {"tokens": route["inputs"][i]}, eager, n, cfg)
            if i == 0:
                eager_launches = paged.launches
            differ += int(not torch.equal(logits, route["logits"][i]))
        self.expect(f"{label}: an eager step launches {eager_launches} paged kernels "
                    f"({per_step})", eager_launches == per_step)
        self.expect(f"{label}: replays == eager decode_step bit for bit ({differ} of "
                    f"{len(lens)} steps differ)", differ == 0)
        del eager
        # the paged kernels' device time in one replay at the last step's length
        step, own = route["step"], route["caches"]
        live = P + G - 1
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            step(params, {"tokens": route["inputs"][-1]}, own, lens[-1])
            torch.cuda.synchronize()
        kernel_us = {}
        for e in prof.events():
            found = PAGED_KERNEL.search(e.name)
            if e.device_type == DeviceType.CUDA and found:
                kernel_us[found[0]] = kernel_us.get(found[0], 0.0) + e.time_range.elapsed_us()
        layer_us = sum(kernel_us.values()) / L
        kv_bytes = 2 * B * live * cfg.num_kv_heads * cfg.head_dim * 2
        bound_us = kv_bytes / PEAK_BYTES_PER_S * 1e6
        out = {"model": SERVE_MODEL, "batch": B, "prompt_len": P, "gen": G,
               "page_size": tf.page_size(S), "layer_check": layer_check,
               "graph_ms_per_token": route["ms"], "plain_graph_ms_per_token": plain_ms,
               "counts": route["counts"],
               "capture_launches": route["launches"], "eager_launches": eager_launches,
               "max_rel_l2_vs_plain": rel, "tokens_alike_vs_plain": agree,
               "steps_differing_eager": differ, "kernel_us_by_name": kernel_us,
               "kernel_us_per_layer": layer_us, "kv_bytes_per_layer": kv_bytes,
               "bound_us_per_layer": bound_us,
               "kernel_share": bound_us / layer_us if layer_us else None,
               "card": self.card, "power_limit": self.power_limit}
        print(f"{label}: {route['ms']:.2f} ms a token through the paged kernel, "
              f"{plain_ms:.2f} through the plain attention; the paged kernels "
              f"{layer_us:.1f} us a layer at {live} positions (bound {bound_us:.1f} us, "
              f"{kv_bytes} bytes) [{self.card}]")
        del route, step, own, pristine, params
        self.free()
        return out

    def route_layer_check(self, tf, cfg, caches, layers, P, g, label) -> dict:
        """Each of ``layers``' post-prefill caches, the slots past the P
        prompt positions filled with random rows at the prompt's scale (what
        decode steps write there), read through the route's view
        (``transformer.paged_view`` / ``kv_pool``) by the paged kernel for a
        random query, against ``attention.decode_attention`` in fp64 at
        cache_len mid, S - 1 and S, at FULL_ATOL/FULL_RTOL; at mid the
        limit must reject the newest token dropped (seq_lens one short) and
        a block table that reads the next sequence's pages."""
        torch = self.torch
        from repro_torch.kernels.paged_attention import ops as paged_ops
        from repro_torch.models import attention

        B, S = caches["k"].shape[1:3]
        worst = {}
        for i in layers:
            k, v = caches["k"][i].clone(), caches["v"][i].clone()
            for c in (k, v):
                scale = c[:, :P].float().std()
                c[:, P:] = (torch.randn(c[:, P:].shape, generator=g, device=DEVICE)
                            * scale).to(c.dtype)
            q = torch.randn(B, cfg.num_heads, cfg.head_dim, generator=g,
                            device=DEVICE).to(k.dtype)
            for cache_len in (S // 2 + 3, S - 1, S):
                n = torch.tensor(cache_len, dtype=torch.int32, device=DEVICE)
                psz, table, lens = tf.paged_view(B, S, n, DEVICE)
                pools = tf.kv_pool(k, psz), tf.kv_pool(v, psz)
                got = paged_ops.paged_attention(q, *pools, table, lens)
                want = attention.decode_attention(q.double(), k.double(), v.double(),
                                                  cache_len + 1)
                worst[f"layer {i} cache_len {cache_len}"] = self.check(
                    f"{label}: layer {i}'s route (pages of {psz}) at cache_len {cache_len} "
                    f"== fp64 plain attention", got, want, FULL_ATOL, FULL_RTOL)
                if cache_len == S // 2 + 3:
                    self.expect_caught(f"{label}: layer {i}, the limit rejects the newest "
                                       f"token dropped",
                                       paged_ops.paged_attention(q, *pools, table, lens - 1),
                                       want, FULL_ATOL, FULL_RTOL)
                    self.expect_caught(f"{label}: layer {i}, the limit rejects the next "
                                       f"sequence's pages",
                                       paged_ops.paged_attention(q, *pools, table.roll(1, 0),
                                                                 lens),
                                       want, FULL_ATOL, FULL_RTOL)
            del k, v, q, want
        self.free()
        return worst

    def serve_output(self, label, cfg, toks, logits):
        """A serve's tokens (SERVE_B, SERVE_GEN) in the vocabulary, and its
        SERVE_GEN logits (SERVE_B, padded vocab) finite."""
        self.expect(f"{label}: tokens {toks.shape} == ({SERVE_B}, {SERVE_GEN}) in "
                    f"[0, {cfg.vocab_size})", toks.shape == (SERVE_B, SERVE_GEN)
                    and 0 <= toks.min() and toks.max() < cfg.vocab_size)
        self.expect(f"{label}: {len(logits)} logits of shape {tuple(logits[0].shape)}, "
                    "all finite", len(logits) == SERVE_GEN and all(
                        tuple(x.shape) == (SERVE_B, cfg.padded_vocab)
                        and bool(self.torch.isfinite(x).all()) for x in logits))

    def serve_profile(self, tf, init_params, init_caches) -> dict:
        """Where the serving time goes: one prefill and DECODE_PROFILE_STEPS
        decode steps of the same model and shapes under torch.profiler
        (fresh seeded weights, zero caches at the prompt's length): the
        host's wall time beside the summed time of the device's kernels,
        and the kernels that take the most."""
        torch = self.torch
        from repro_torch.configs import get_config

        cfg = get_config(SERVE_MODEL).model
        self.free()
        g = torch.Generator(device=DEVICE).manual_seed(10)
        params = init_params(cfg, g, DEVICE)
        toks = torch.randint(0, cfg.vocab_size, (SERVE_B, SERVE_PROMPT), generator=g,
                             device=DEVICE)
        caches = init_caches(cfg, SERVE_B, SERVE_PROMPT + SERVE_GEN, DEVICE)
        out = self.profile_calls((
            ("prefill", lambda: tf.prefill(params, {"tokens": toks}, cfg), 1),))
        out.update(self.decode_profiles(tf, cfg, params, caches, toks[:, -1]))
        del params, caches, toks
        self.free()
        return out

    def decode_profiles(self, tf, cfg, params, caches, tokens) -> dict:
        """DECODE_PROFILE_STEPS eager ``decode_step``s at cache_len
        SERVE_PROMPT, then as many replays of the serve step's CUDA graph
        (``launch.step.build_serve_step``) on the same inputs, each under
        torch.profiler after a warm-up."""
        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.launch.step import build_serve_step

        step = {"tokens": tokens}
        tf.decode_step(params, step, caches, SERVE_PROMPT, cfg)
        n = torch.tensor(SERVE_PROMPT, dtype=torch.int32, device=DEVICE)
        graph = build_serve_step(dataclasses.replace(get_config(cfg.name), model=cfg),
                                 device=DEVICE)
        graph(params, step, caches, n)
        out = self.profile_calls((
            ("decode", lambda: tf.decode_step(params, step, caches, SERVE_PROMPT, cfg),
             DECODE_PROFILE_STEPS),
            ("decode graph", lambda: graph(params, step, caches, n), DECODE_PROFILE_STEPS)))
        del graph
        return out

    def profile_calls(self, calls, top: int = 5) -> dict:
        """For each (name, fn, n) of ``calls``, n calls of fn under
        torch.profiler: the host's wall time a call beside the summed time
        of the device's kernels, and the ``top`` kernels that take the
        most."""
        torch = self.torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        out = {}
        for name, fn, n in calls:
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3 / n
            by_name, host_calls = {}, {}
            for e in prof.events():
                if e.device_type == DeviceType.CUDA:
                    by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
                elif HOST_LAUNCH_API.match(e.name):
                    host_calls[e.name] = host_calls.get(e.name, 0) + 1
            busy_ms = sum(by_name.values()) / 1e3 / n
            slow = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
            gemm = sum(v for k, v in by_name.items() if GEMM_KERNEL.search(k))
            out[name] = {"wall_ms": wall_ms, "kernels": sum(1 for e in prof.events()
                                                            if e.device_type == DeviceType.CUDA) // n,
                         "device_busy_ms": busy_ms if by_name else None,
                         "device_busy_share": busy_ms / wall_ms if by_name else None,
                         "gemm_ms": gemm / 1e3 / n if by_name else None,
                         "host_launch_calls": sum(host_calls.values()) / n,
                         "host_launch_calls_by_api": {k: v / n for k, v in host_calls.items()},
                         "top_kernels_ms": {k[:80]: v / 1e3 / n for k, v in slow}}
            print(f"profile {name}: wall {wall_ms:.2f} ms, device kernels "
                  + (f"{busy_ms:.2f} ms ({busy_ms / wall_ms:.3f} busy) in "
                     f"{out[name]['kernels']} launches" if by_name else "not measured "
                     "(the profiler saw no device activity)")
                  + f", {out[name]['host_launch_calls']:g} host launch calls a call "
                  f"{out[name]['host_launch_calls_by_api']} [{self.card}]")
        return out

    def model_checks(self, tf, init_params):
        """qwen2-7b at full width and depth held on the card: bf16 against
        the same weights in fp32, two injected faults, and fp32 prefill +
        decode against the full forward."""
        import dataclasses

        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.launch.serve import rehome_caches

        cfg = get_config(SERVE_MODEL).model
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        print(f"== model checks: {SERVE_MODEL} full width, S={CHECK_S} + {CHECK_EXTRA}")
        self.free()
        torch.cuda.reset_peak_memory_stats()
        g = torch.Generator(device=DEVICE).manual_seed(7)
        params = init_params(cfg, g, DEVICE)
        toks = torch.randint(0, cfg.vocab_size, (1, CHECK_S + CHECK_EXTRA), generator=g,
                             device=DEVICE)
        prompt = {"tokens": toks[:, :CHECK_S]}
        V = cfg.vocab_size  # the padding columns hold -1e30 on both sides

        def last_logits(c):
            return tf.prefill(params, prompt, c)[0][:, :V].float()

        got_bf16 = last_logits(cfg)
        params.float()  # parameter by parameter: the bf16 copy goes as fp32 comes
        self.free()
        want = last_logits(cfg32)

        def rel(x):
            return ((x - want).norm(dim=-1) / want.norm(dim=-1)).max().item()

        err = rel(got_bf16)
        self.expect(f"model bf16 vs fp32 last logits: rel L2 {err:.4e} <= {BF16_LOGIT_REL}",
                    err <= BF16_LOGIT_REL)
        # fault 1: one layer's wo zeroed
        wo = params.blocks[WO_FAULT_LAYER].attn.wo
        saved = wo.detach().clone()
        with torch.no_grad():
            wo.zero_()
        try:
            fault_wo = rel(last_logits(cfg32))
        finally:
            with torch.no_grad():
                wo.copy_(saved)
        del saved
        # fault 2: one layer's queries rotated one position ahead of its keys
        rotate, calls = tf._rotate, [0]

        def off_by_one(q, k, positions, c):
            layer, calls[0] = calls[0], calls[0] + 1
            if layer != ROPE_FAULT_LAYER:
                return rotate(q, k, positions, c)
            return rotate(q, k, positions + 1, c)[0], rotate(q, k, positions, c)[1]

        tf._rotate = off_by_one
        try:
            fault_rope = rel(last_logits(cfg32))
        finally:
            tf._rotate = rotate
        for name, e in ((f"wo of layer {WO_FAULT_LAYER} zeroed", fault_wo),
                        (f"RoPE positions off by one in layer {ROPE_FAULT_LAYER}",
                         fault_rope)):
            self.expect(f"the bf16 limit catches {name}: rel L2 {e:.4e} > {BF16_LOGIT_REL}",
                        e > BF16_LOGIT_REL)

        # fp32 prefill + teacher-forced decode == the full forward
        with torch.no_grad():
            full = params({"tokens": toks})[:, -1, :V]
        _, c = tf.prefill(params, prompt, cfg32)
        caches = rehome_caches(cfg32, c, 1, CHECK_S + CHECK_EXTRA, DEVICE)
        del c
        for i in range(CHECK_EXTRA):
            out, caches = tf.decode_step(params, {"tokens": toks[:, CHECK_S + i]}, caches,
                                         CHECK_S + i, cfg32)
        dec_err = self.check(f"model fp32 prefill {CHECK_S} + {CHECK_EXTRA} decode steps vs "
                             "full forward (full width)", out[:, :V], full, MODEL_ATOL,
                             MODEL_RTOL)
        peak = torch.cuda.max_memory_allocated()
        self.expect(f"model checks peak {peak} bytes < 70 GB", peak < 70e9)
        del params, caches, got_bf16, want, full, out
        self.free()
        families = self.family_checks(tf, init_params)
        print(json.dumps({"model_checks": {
            "model": SERVE_MODEL, "bf16_vs_fp32_rel_l2": err, "limit": BF16_LOGIT_REL,
            "fault_wo_zeroed_rel_l2": fault_wo, "fault_layer_wo": WO_FAULT_LAYER,
            "fault_rope_off_by_one_rel_l2": fault_rope, "fault_layer_rope": ROPE_FAULT_LAYER,
            "prefill_decode_vs_full_max_abs_err": dec_err,
            "prefill_decode_tol": [MODEL_ATOL, MODEL_RTOL], "max_memory_allocated": peak,
            "families": families}}))

    # -- the moe, ssm and hybrid families ----------------------------------

    @staticmethod
    def family_cfg(name, layers=None):
        """The model's config at full width, cut to ``layers`` or
        FAMILY_LAYERS."""
        import dataclasses

        from repro_torch.configs import get_config

        cfg = get_config(name).model
        return dataclasses.replace(
            cfg, num_layers=layers or FAMILY_LAYERS.get(name, cfg.num_layers))

    @staticmethod
    def serve_bounds(cfg, params, init_caches) -> dict:
        """serve_path's bounds for any family.  Prefill: 2 x the matrix
        weights a token uses (the top-k experts' share of the expert
        weights) x the prompt tokens, the head at the last positions, and
        QK^T and PV over the causal band (the window where it is shorter),
        at the bf16 peak.  A decode step's bytes: the layers' weights, the
        final norm and the head (a tied table read once, as the head) and
        the tokens' embedding rows; the live K/V rows; the recurrent
        states (rwkv's, Mamba's), read and written; at the memory rate."""
        L, d, V = cfg.num_layers, cfg.d_model, cfg.padded_vocab
        B, P, G = SERVE_B, SERVE_PROMPT, SERVE_GEN
        mats, layer_bytes = 0.0, 0
        for name, p in params.blocks[0].named_parameters():
            layer_bytes += p.numel() * p.element_size()
            if p.ndim >= 2 and name.split(".")[-1] not in ("u", "A_log", "conv_w"):
                mats += p.numel() * (cfg.top_k / cfg.num_experts if p.ndim == 3 else 1)
        window = cfg.sliding_window or P + G
        pairs = sum(min(q + 1, window) for q in range(P))
        flops = (2 * mats * L * B * P + 2 * d * V * B
                 + 4 * cfg.num_heads * cfg.head_dim * pairs * L * B)
        head = params.embedding if params.lm_head is None else params.lm_head
        elt = head.element_size()
        weights = (L * layer_bytes + sum(p.numel() for p in params.final_norm.parameters()) * elt
                   + head.numel() * elt + B * d * elt)
        live = min(P + G / 2, window)  # positions attended, over the steps
        kv = 2 * L * B * live * cfg.num_kv_heads * cfg.head_dim * elt
        caches = init_caches(cfg, B, P + G, "meta")
        state = 2 * sum(c.numel() * c.element_size() for n, c in caches.items()
                        if n not in ("k", "v"))
        nbytes = weights + kv + state
        return {"prefill_flops": flops, "prefill_bound_ms": flops / PEAK_BF16_FLOPS * 1e3,
                "decode_bytes": nbytes, "decode_state_bytes": state,
                "decode_bound_ms": nbytes / PEAK_BYTES_PER_S * 1e3}

    def family_serve(self, tf, init_params, init_caches):
        """serve_path for each of FAMILY_MODELS: ``launch.serve.serve`` at
        full width (mixtral cut in depth), bf16, B 8, a 2,048-token prompt
        batch from ``data.pipeline.prefetched``, 32 tokens; for mixtral the
        share of (token, choice) pairs its MoE dropped, counted in a second
        serve of the same prompts; then DECODE_PROFILE_STEPS decode steps
        of the served model and one prefill of a PROFILE_LAYERS-deep copy
        under torch.profiler."""
        import dataclasses

        torch = self.torch
        from repro_torch.configs import ShapeConfig, get_config
        from repro_torch.data.pipeline import prefetched
        from repro_torch.launch.serve import serve

        out = {}
        for i, name in enumerate(FAMILY_MODELS):
            cfg = self.family_cfg(name)
            depth = get_config(name).model.num_layers
            self.start_app(f"serve {name} full width, {cfg.num_layers} of {depth} layers, "
                           f"B={SERVE_B} prompt={SERVE_PROMPT} gen={SERVE_GEN} {cfg.dtype}")
            t0 = time.perf_counter()
            g = torch.Generator(device=DEVICE).manual_seed(20 + i)
            params = init_params(cfg, g, DEVICE)
            prompt = next(iter(prefetched(
                cfg, ShapeConfig("serve", SERVE_PROMPT, SERVE_B, "prefill"), device=DEVICE,
                depth=2)))
            rec = {}
            with GraphHeld(self, tf) as held, PrefillHeld(self, tf) as held_prefill:
                toks = serve(name, reduced=False, batch=SERVE_B, prompt_len=SERVE_PROMPT,
                             gen=SERVE_GEN, device=DEVICE, params=params, prompts=[prompt],
                             record=rec, keep_logits=True)
                torch.cuda.synchronize()
                peak = torch.cuda.max_memory_allocated()
                counts = {n: fn.launches for n, fn in self.counters.items()}
                graph = held.check(f"serve {name}", toks, rec)
                prefill_graph = held_prefill.check(f"serve {name}", rec)
            self.serve_output(f"serve {name}", cfg, toks, rec.pop("logits"))
            row = {"model": name, "layers": cfg.num_layers, "of_layers": depth,
                   "batch": SERVE_B, "prompt_len": SERVE_PROMPT, "gen": SERVE_GEN,
                   "dtype": cfg.dtype, "params": sum(p.numel() for p in params.parameters()),
                   "weight_bytes": sum(p.numel() * p.element_size() for p in params.parameters()),
                   **rec, "max_memory_allocated": peak,
                   **self.serve_bounds(cfg, params, init_caches), "graph": graph,
                   "prefill_graph": prefill_graph, "kernel_launches": counts, "card": self.card,
                   "power_limit": self.power_limit}
            row["prefill_share"] = row["prefill_bound_ms"] / rec["prefill_ms"]
            row["decode_share"] = row["decode_bound_ms"] / rec["decode_ms_per_token"]
            seconds = {"serve": time.perf_counter() - t0}
            if cfg.num_experts:
                t0 = time.perf_counter()
                row["dropped"] = self.moe_drops(serve, name, params, prompt)
                seconds["moe_drops"] = time.perf_counter() - t0
            print(f"serve {name}: prefill {rec['prefill_ms']:.1f} ms (bound "
                  f"{row['prefill_bound_ms']:.1f} ms), decode {rec['decode_ms_per_token']:.2f} "
                  f"ms/token as a CUDA graph, {graph['eager_ms_per_token']:.2f} eager (bound "
                  f"{row['decode_bound_ms']:.3f} ms), capture {rec['capture_ms']:.1f} ms, "
                  f"{rec['tokens_per_s']:.1f} tokens/s, peak {peak} bytes; kernel launches "
                  f"{counts}")
            # profiles: decode at the served depth, prefill at PROFILE_LAYERS
            t0 = time.perf_counter()
            caches = init_caches(cfg, SERVE_B, SERVE_PROMPT + SERVE_GEN, DEVICE)
            row["profile"] = self.decode_profiles(tf, cfg, params, caches,
                                                  prompt["tokens"][:, -1])
            del params, caches
            self.free()
            cut = dataclasses.replace(cfg, num_layers=min(PROFILE_LAYERS, cfg.num_layers))
            params = init_params(cut, g, DEVICE)
            tokens = {"tokens": prompt["tokens"]}
            row["profile"].update(self.profile_calls((
                (f"prefill of {cut.num_layers} layers",
                 lambda: tf.prefill(params, tokens, cut), 1),)))
            row["profile_prefill_layers"] = cut.num_layers
            del params, prompt, tokens
            self.free()
            seconds["profiles"] = time.perf_counter() - t0
            row["seconds"] = seconds
            print(f"serve {name}: script seconds " + ", ".join(
                f"{k} {v:.1f}" for k, v in seconds.items()))
            out[name] = row
        print(json.dumps({"family_serve": out}))

    def moe_drops(self, serve, name, params, prompt) -> dict:
        """The share of (token, choice) pairs the MoE dropped in the
        prefill and in the decode steps of one serve of ``prompt``.  The
        count runs in Python at each routing, which a graph's replay skips,
        so this serve prefills and decodes with eager steps (the graphs'
        are bit for bit the same, ``PrefillHeld.check`` and
        ``GraphHeld.check``)."""
        from repro_torch.launch import serve as serve_mod
        from repro_torch.models import moe as moe_lib
        from repro_torch.models import transformer as tf

        class EagerStep:
            def __init__(self, arch, mesh=None, *, device=None):
                self.cfg, self.logits, self.capture_ms = arch.model, None, 0.0

            def capture(self, *args):
                pass

            def __call__(self, params, batch, caches, cache_len):
                self.logits, caches = tf.decode_step(params, batch, caches, cache_len, self.cfg)
                return self.logits.argmax(dim=-1), caches

        class EagerPrefill(EagerStep):
            def __call__(self, params, batch):
                self.logits, caches = tf.prefill(params, batch, self.cfg)
                return self.logits.argmax(dim=-1), caches

        calls, real, real_step = [], moe_lib._routing, serve_mod.build_serve_step
        real_prefill = serve_mod.build_prefill_step

        def counted(x_flat, *args):
            got = real(x_flat, *args)
            keep = got[3]
            calls.append((keep.numel(), keep.numel() - keep.sum()))
            return got

        moe_lib._routing, serve_mod.build_serve_step = counted, EagerStep
        serve_mod.build_prefill_step = EagerPrefill
        try:
            serve(name, reduced=False, batch=SERVE_B, prompt_len=SERVE_PROMPT, gen=SERVE_GEN,
                  device=DEVICE, params=params, prompts=[prompt])
        finally:
            moe_lib._routing, serve_mod.build_serve_step = real, real_step
            serve_mod.build_prefill_step = real_prefill
        out = {}
        L = len(params.blocks)
        for phase, part in (("prefill", calls[:L]), ("decode", calls[L:])):
            pairs = sum(n for n, _ in part)
            dropped = int(sum(d for _, d in part))
            out[phase] = {"pairs": pairs, "dropped": dropped, "share": dropped / pairs}
        print(f"moe {name}: dropped (token, choice) pairs: prefill {out['prefill']['dropped']} "
              f"of {out['prefill']['pairs']} ({out['prefill']['share']:.4%}), decode "
              f"{out['decode']['dropped']} of {out['decode']['pairs']} "
              f"({out['decode']['share']:.4%}, capacity factor 2.0 over a group of the batch)")
        return out

    def family_checks(self, tf, init_params) -> dict:
        """Each of FAMILY_MODELS at full width held on the card (mixtral
        at FAMILY_CHECK_LAYERS): bf16 against the same weights in fp32 (MoE
        routed alike, ``routing``), the family's fault, and for rwkv and
        hymba fp32 prefill + decode against the full forward; then one
        full-width mixtral MoE layer against a per-token loop."""
        import dataclasses

        torch = self.torch
        from repro_torch.launch.serve import rehome_caches

        out = {}
        for i, name in enumerate(FAMILY_MODELS):
            cfg = self.family_cfg(name, FAMILY_CHECK_LAYERS.get(name))
            cfg32 = dataclasses.replace(cfg, dtype="float32")
            limit = FAMILY_BF16_LOGIT_REL.get(name, BF16_LOGIT_REL)
            print(f"== model checks: {name} full width, {cfg.num_layers} layers, "
                  f"S={CHECK_S} + {CHECK_EXTRA}")
            self.free()
            torch.cuda.reset_peak_memory_stats()
            g = torch.Generator(device=DEVICE).manual_seed(30 + i)
            params = init_params(cfg, g, DEVICE)
            toks = torch.randint(0, cfg.vocab_size, (1, CHECK_S + CHECK_EXTRA), generator=g,
                                 device=DEVICE)
            prompt = {"tokens": toks[:, :CHECK_S]}
            V = cfg.vocab_size

            def last_logits(c):
                return tf.prefill(params, prompt, c)[0][:, :V].float()

            choices = []
            with routing(choices):
                got_bf16 = last_logits(cfg)
            params.float()
            self.free()
            with routing(choices, replay=True):
                want = last_logits(cfg32)

            def rel(x):
                return ((x - want).norm(dim=-1) / want.norm(dim=-1)).max().item()

            row = {"layers": cfg.num_layers, "bf16_vs_fp32_rel_l2": rel(got_bf16),
                   "limit": limit}
            self.expect(f"{name} bf16 vs fp32 last logits: rel L2 "
                        f"{row['bf16_vs_fp32_rel_l2']:.4e} <= {limit}",
                        row["bf16_vs_fp32_rel_l2"] <= limit)
            if cfg.num_experts:  # how often bf16 rounding alone flips an expert
                own = []
                with routing(own):
                    unrouted = last_logits(cfg32)
                row["fp32_own_routing_rel_l2"] = ((got_bf16 - unrouted).norm(dim=-1)
                                                  / unrouted.norm(dim=-1)).max().item()
                row["choices_flipped"] = sum(int((a != b).sum()) for a, b in zip(choices, own))
                row["choices"] = sum(a.numel() for a in choices)
                print(f"{name}: fp32 with its own routing flips {row['choices_flipped']} of "
                      f"{row['choices']} expert choices of the bf16 run; its logits "
                      f"{row['fp32_own_routing_rel_l2']:.4e} from bf16's")
                del unrouted, own
            with family_fault(params) as label, routing(choices, replay=True):
                row["fault"], row["fault_rel_l2"] = label, rel(last_logits(cfg32))
            self.expect(f"the {name} limit catches {label}: rel L2 {row['fault_rel_l2']:.4e} "
                        f"> {limit}", row["fault_rel_l2"] > limit)
            del choices, got_bf16
            if cfg.family in ("ssm", "hybrid"):
                with torch.no_grad():
                    full = params({"tokens": toks})[:, -1, :V]
                _, c = tf.prefill(params, prompt, cfg32)
                caches = rehome_caches(cfg32, c, 1, CHECK_S + CHECK_EXTRA, DEVICE)
                del c
                for j in range(CHECK_EXTRA):
                    last, caches = tf.decode_step(params, {"tokens": toks[:, CHECK_S + j]},
                                                  caches, CHECK_S + j, cfg32)
                row["prefill_decode_vs_full_max_abs_err"] = self.check(
                    f"{name} fp32 prefill {CHECK_S} + {CHECK_EXTRA} decode steps vs full "
                    "forward (full width)", last[:, :V], full, MODEL_ATOL, MODEL_RTOL)
                del full, caches, last
            row["max_memory_allocated"] = torch.cuda.max_memory_allocated()
            self.expect(f"{name} model checks peak {row['max_memory_allocated']} bytes < 70 GB",
                        row["max_memory_allocated"] < 70e9)
            del params, want, toks, prompt
            self.free()
            out[name] = row
        out["moe_layer_vs_loop"] = self.moe_loop_check()
        return out

    def moe_loop_check(self) -> dict:
        """One full-width mixtral MoE layer in fp32 on MOE_LOOP_TOKENS
        tokens, with a capacity that drops nothing, against a plain loop
        over the tokens: its top-k experts by the router's softmax, the
        gates renormalised, each expert's SwiGLU, the weighted sum."""
        torch = self.torch
        import torch.nn.functional as F

        from repro_torch.models import moe as moe_lib

        cfg = self.family_cfg("mixtral-8x22b")
        k, e = cfg.top_k, cfg.num_experts
        self.free()
        g = torch.Generator(device=DEVICE).manual_seed(40)
        layer = moe_lib.MoE(cfg.d_model, cfg.d_ff, e, cfg.activation, torch.float32, DEVICE, g)
        x = torch.randn((1, MOE_LOOP_TOKENS, cfg.d_model), generator=g, device=DEVICE)
        with torch.no_grad():
            x_flat, capacity = moe_lib._groups(x, MOE_LOOP_TOKENS, k, e / k, e)
            self.expect(f"moe loop check: capacity {capacity} takes every token",
                        capacity == MOE_LOOP_TOKENS)
            got, _ = moe_lib.moe(layer, x, top_k=k, activation=cfg.activation,
                                 capacity_factor=e / k, group_size=MOE_LOOP_TOKENS)
            probs = torch.softmax(x[0] @ layer.router, dim=-1)
            want = torch.zeros_like(x[0])
            for t in range(MOE_LOOP_TOKENS):
                vals, idx = torch.topk(probs[t], k)
                for gate, j in zip((vals / vals.sum()).unbind(), idx.tolist()):
                    xt = x[0, t]
                    h = F.silu(xt @ layer.w_gate[j]) * (xt @ layer.w_up[j])
                    want[t] += gate * (h @ layer.w_down[j])
        err = self.check(f"mixtral MoE layer (fp32, full width) vs a per-token loop over "
                         f"{MOE_LOOP_TOKENS} tokens", got[0], want, MOE_LOOP_ATOL, MOE_LOOP_RTOL)
        del layer, x, got, want, probs
        self.free()
        return {"tokens": MOE_LOOP_TOKENS, "max_abs_err": err,
                "tol": [MOE_LOOP_ATOL, MOE_LOOP_RTOL]}

    def copy_rates(self) -> dict:
        """Host<->device rates of a COPY_BYTES buffer, pinned and pageable,
        median of COPY_REPS CUDA-event timings."""
        torch = self.torch
        n = COPY_BYTES // 4
        dev = torch.empty(n, device=DEVICE)
        pinned = torch.ones(n, pin_memory=True)
        pageable = torch.ones(n)
        cases = {"h2d_pinned": lambda: dev.copy_(pinned, non_blocking=True),
                 "h2d_pageable": lambda: dev.copy_(pageable),
                 "d2h_pinned": lambda: pinned.copy_(dev, non_blocking=True),
                 "d2h_pageable": lambda: pageable.copy_(dev)}
        rates = {name: COPY_BYTES / (self.time_ms(fn, reps=COPY_REPS) / 1e3)
                 for name, fn in cases.items()}
        print("copy rates (bytes/s, 256 MiB): " + ", ".join(
            f"{k} {v:.4e}" for k, v in rates.items()))
        return rates

    def prefetch_path(self, rates) -> dict:
        """ms per step of a loop that takes a batch and runs a fixed device
        workload, with no iterator (a synchronous pageable copy) and with
        the PrefetchIterator at depths 1 and 2; then every delivered batch
        held bit for bit against the batch synthetic_batches made, under a
        slow consumer."""
        import itertools

        torch = self.torch
        from repro_torch.configs import ShapeConfig, get_config
        from repro_torch.core.prefetch import PrefetchIterator
        from repro_torch.data.pipeline import synthetic_batches

        cfg = get_config(PREFETCH_MODEL).model
        shape = ShapeConfig("prefetch", PREFETCH_S, PREFETCH_B, "train")
        t0 = time.perf_counter()
        batches = list(itertools.islice(synthetic_batches(cfg, shape), PREFETCH_DISTINCT))
        make_s = time.perf_counter() - t0
        nbytes = sum(a.nbytes for a in batches[0].values())
        ref = [{k: torch.from_numpy(v).to(DEVICE) for k, v in b.items()} for b in batches]
        staged = {k: torch.from_numpy(v).pin_memory() for k, v in batches[0].items()}
        dst = {k: torch.empty_like(v) for k, v in ref[0].items()}
        t_copy = self.time_ms(lambda: [dst[k].copy_(staged[k], non_blocking=True)
                                       for k in staged], reps=COPY_REPS)
        stage_ms = []
        for _ in range(3):  # the host copy of a NumPy batch into pinned memory
            t0 = time.perf_counter()
            for k, v in batches[1].items():
                staged[k].copy_(torch.from_numpy(v))
            stage_ms.append((time.perf_counter() - t0) * 1e3)
        del staged, dst
        a = torch.randn((4096, 4096), device=DEVICE, dtype=torch.bfloat16)
        c = torch.empty_like(a)
        one = self.time_ms(lambda: torch.mm(a, a, out=c))
        reps = max(1, round(t_copy / one))

        def work():
            for _ in range(reps):
                torch.mm(a, a, out=c)

        t_work = self.time_ms(work)
        self.expect(f"prefetch workload {t_work:.3f} ms within 0.5-2x of the batch's copy "
                    f"{t_copy:.3f} ms", 0.5 <= t_work / t_copy <= 2.0)

        def run(depth, steps, slow=False):
            src = (batches[i % PREFETCH_DISTINCT] for i in range(steps))
            it = (({k: torch.from_numpy(v).to(DEVICE) for k, v in b.items()} for b in src)
                  if depth == 0 else PrefetchIterator(src, DEVICE, depth=depth))
            bad = torch.zeros((), dtype=torch.int64, device=DEVICE)
            n = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i, b in enumerate(it):
                work()
                if slow:  # a slow consumer: a race of the copies would show
                    work()
                    work()
                    for k, v in b.items():
                        bad += (v != ref[i % PREFETCH_DISTINCT][k]).sum()
                n += 1
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) / max(n, 1) * 1e3, n, int(bad)

        ms = {}
        for depth in (0, 1, 2):
            run(depth, PREFETCH_WARM)
            ms[depth], n, _ = run(depth, PREFETCH_STEPS)
        overlap = {d: (ms[0] - ms[d]) / t_copy for d in (1, 2)}
        for depth in (1, 2):
            _, n, bad = run(depth, PREFETCH_STEPS, slow=True)
            self.expect(f"prefetch depth {depth}: {n} batches under a slow consumer equal "
                        f"synthetic_batches' bit for bit ({bad} elements differ)",
                        n == PREFETCH_STEPS and bad == 0)
        print(f"prefetch {nbytes} bytes a batch: copy {t_copy:.3f} ms (pinned), host staging "
              f"{statistics.median(stage_ms):.3f} ms, workload {t_work:.3f} ms; ms/step "
              f"sync {ms[0]:.3f}, depth 1 {ms[1]:.3f}, depth 2 {ms[2]:.3f}; overlap "
              f"{overlap[1]:.3f} / {overlap[2]:.3f} of the copy")
        del ref, a, c
        self.free()
        return {"model": PREFETCH_MODEL, "batch_bytes": nbytes, "steps": PREFETCH_STEPS,
                "distinct_batches": PREFETCH_DISTINCT, "make_batches_s": make_s,
                "copy_ms": t_copy, "copy_bytes_per_s": nbytes / (t_copy / 1e3),
                "host_staging_ms": statistics.median(stage_ms), "workload_ms": t_work,
                "workload_matmuls": reps, "ms_per_step": {f"depth{d}": ms[d] for d in ms},
                "overlap": {f"depth{d}": overlap[d] for d in overlap}}

    def streaming_path(self, Block) -> dict:
        """fetch_params / offload_params of one full-width qwen2-7b layer."""
        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.core.streaming import fetch_params, offload_params

        cfg = get_config(SERVE_MODEL).model
        g = torch.Generator(device=DEVICE).manual_seed(8)
        layer = {n: p.detach() for n, p in
                 Block(cfg, torch.bfloat16, DEVICE, g).named_parameters()}
        nbytes = sum(t.numel() * t.element_size() for t in layer.values())
        host = {}

        def offload():
            host.update(offload_params(layer, DEVICE))

        off_ms = self.time_ms(offload, reps=COPY_REPS)
        self.expect("offload_params gives pinned host copies",
                    all(t.is_pinned() and not t.is_cuda for t in host.values()))
        back = {}
        fetch_ms = self.time_ms(lambda: back.update(fetch_params(host, DEVICE)),
                                reps=COPY_REPS)
        torch.cuda.synchronize()
        self.expect("fetch_params(offload_params(layer)) == layer bit for bit",
                    all(torch.equal(back[n], layer[n]) for n in layer))
        out = {"params": sum(t.numel() for t in layer.values()), "bytes": nbytes,
               "offload_ms": off_ms, "fetch_ms": fetch_ms,
               "offload_bytes_per_s": nbytes / (off_ms / 1e3),
               "fetch_bytes_per_s": nbytes / (fetch_ms / 1e3)}
        print(f"streaming one {SERVE_MODEL} layer ({nbytes} bytes bf16): offload "
              f"{off_ms:.3f} ms, fetch {fetch_ms:.3f} ms")
        del layer, host, back
        self.free()
        return out

    def remat_path(self, tf, init_params) -> dict:
        """Loss and gradients of a 2-layer full-width qwen2-7b in fp32 under
        each remat policy, held to "none", "offload" bit for bit to "full";
        the peak device memory of each, "offload"'s held to "full"'s."""
        import dataclasses

        torch = self.torch
        from repro_torch.configs import get_config
        from repro_torch.core.streaming import checkpoint_layer

        cfg = dataclasses.replace(get_config(SERVE_MODEL).model, num_layers=2,
                                  dtype="float32")
        g = torch.Generator(device=DEVICE).manual_seed(9)
        params = init_params(cfg, g, DEVICE)
        toks = torch.randint(0, cfg.vocab_size, (1, REMAT_S), generator=g, device=DEVICE)
        batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}
        # the first checkpoint of a process pays a one-time set-up (seconds:
        # imports inside torch.utils.checkpoint), kept out of the rows
        t0 = time.perf_counter()
        x = torch.ones(8, device=DEVICE, requires_grad=True)
        for kind in ("full", "dots", "offload"):
            checkpoint_layer(lambda y: (y * 2).sin(), kind)(x).sum().backward()
        torch.cuda.synchronize()
        first_use_s = time.perf_counter() - t0
        out, ref, full = {"checkpoint_first_use_s": first_use_s}, None, None
        for kind in ("none", "full", "dots", "offload"):
            params.zero_grad(set_to_none=True)
            self.free()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            loss = tf.loss_fn(params, batch, cfg, remat=kind)
            loss.backward()
            torch.cuda.synchronize()
            row = {"ms": (time.perf_counter() - t0) * 1e3,
                   "max_memory_allocated": torch.cuda.max_memory_allocated(),
                   "peak_above_params": torch.cuda.max_memory_allocated() - base,
                   "loss": loss.item()}
            grads = [p.grad for p in params.parameters()]
            if ref is None:
                ref = (loss.detach(), [x.clone() for x in grads])
            else:
                row["loss_err"] = abs(loss.item() - ref[0].item())
                row["grad_max_abs_err"] = max((x - y).abs().max().item()
                                              for x, y in zip(grads, ref[1]))
                self.expect(f"remat {kind}: loss and gradients == none's (loss err "
                            f"{row['loss_err']:.3e}, grad err {row['grad_max_abs_err']:.3e}"
                            f" <= {REMAT_ATOL})", row["loss_err"] <= REMAT_ATOL
                            and row["grad_max_abs_err"] <= REMAT_ATOL)
            if kind == "full":
                full = (loss.detach(), [x.clone() for x in grads])
            elif kind == "offload":
                apart = sum(not x.equal(y) for x, y in zip(grads, full[1]))
                peak_rel = row["peak_above_params"] / out["full"]["peak_above_params"] - 1
                row.update(grads_apart_from_full=apart, peak_rel_to_full=peak_rel,
                           full_ms=out["full"]["ms"])
                self.expect(f"remat offload: loss and gradients == full's bit for bit ("
                            f"{apart} of {len(grads)} gradients apart, loss "
                            f"{loss.item()!r} / {full[0].item()!r}), as the reference's "
                            "offload recomputes", apart == 0 and loss.equal(full[0]))
                self.expect(f"remat offload: peak {row['peak_above_params']} bytes above the "
                            f"params, full's {out['full']['peak_above_params']} ("
                            f"{peak_rel:+.4f}, limit {REMAT_PEAK_TOL}) [{self.card}]",
                            abs(peak_rel) <= REMAT_PEAK_TOL)
            out[kind] = row
            print(f"remat {kind}: {row['ms']:.1f} ms"
                  + (f" (full {row['full_ms']:.1f} ms)" if kind == "offload" else "")
                  + f", peak {row['max_memory_allocated']} bytes ({row['peak_above_params']} "
                  f"above what was allocated before) [{self.card}]")
            del loss, grads
        del params, ref, full
        self.free()
        return out

    def movement_path(self, tf, init_params, Block):
        """The movement layer on the card: copy rates, the prefetch
        iterator, layer streaming and the remat policies."""
        print("== movement layer: copy rates, PrefetchIterator, streaming, remat")
        self.free()
        rates = self.rates = self.copy_rates()
        prefetch = self.prefetch_path(rates)
        streaming = self.streaming_path(Block)
        remat = self.remat_path(tf, init_params)
        print(json.dumps({"movement_path": {
            "copy_bytes_per_s": rates, "prefetch": prefetch, "streaming": streaming,
            "remat": remat, "power_limit": self.power_limit}}))

    # -- the UM simulator and the paper's sweep engine ---------------------

    def um_claims(self, harness, cells) -> list[dict]:
        """The paper's five findings on the seed cells of ``cells``."""
        seed = [c for c in cells if c.platform in harness.DEFAULT_PLATFORMS
                and c.regime in harness.DEFAULT_REGIMES and c.variant in harness.VARIANTS]
        self.expect(f"um seed cells in the extended matrix ({len(seed)})", len(seed) == 240)
        speedups = harness.speedup_vs_um(seed)
        out = []
        for claim, app, plat, regime, variant, limit in UM_CLAIMS:
            s = speedups.get((app, plat, regime, variant, "group"))
            ok = s is not None and UM_CLAIM_LIMITS[limit](s)
            self.expect(f"um claim {claim}: {app} {plat} {regime} {variant} "
                        f"speedup {s} ({limit}) [{self.card}]", ok)
            out.append({"claim": claim, "cell": [app, plat, regime, variant],
                        "speedup": s, "limit": limit, "ok": ok})
        for app in UM_CLAIM4_APPS:
            intel = speedups[(app, "intel-volta-pcie", "in_memory", "um_prefetch", "group")]
            p9 = speedups[(app, "p9-volta-nvlink", "in_memory", "um_prefetch", "group")]
            self.expect(f"um claim 4: {app} prefetch speedup intel-volta {intel} > "
                        f"p9-volta {p9} [{self.card}]", intel > p9)
            out.append({"claim": 4, "cell": [app, "intel-volta-pcie vs p9-volta-nvlink",
                                             "in_memory", "um_prefetch"],
                        "speedup": [intel, p9], "limit": "intel > p9", "ok": intel > p9})
        na = ("bs", "intel-pascal-pcie", "oversubscribed", "explicit", "group")
        self.expect("um claim 5: explicit N/A when oversubscribed", na not in speedups)
        return out

    def um_sweep(self, harness, plat) -> dict:
        """(a) The extended matrix, serially from the main thread (the
        per-cell deadline is SIGALRM-based)."""
        t0 = time.perf_counter()
        cells = harness.run_extended_matrix()
        wall = time.perf_counter() - t0
        errors = [c for c in cells if c.error is not None]
        self.expect(f"um extended matrix: {len(cells)} cells, {len(errors)} errors "
                    f"in {wall:.3f} s [{self.card}]", len(cells) == 1152 and not errors)
        want_na = set()
        for c in cells:
            p = plat.PLATFORMS[c.platform]
            coherent = p.host_can_access_device and p.device_can_access_host
            if (c.variant == "explicit" and c.regime != "in_memory") or (
                    c.variant in ("svm_remote", "um_hybrid_counters") and not coherent):
                want_na.add((c.app, c.platform, c.variant, c.regime))
        na = {(c.app, c.platform, c.variant, c.regime) for c in cells if c.report is None}
        self.expect(f"um N/A cells exactly at the gates ({len(na)} of {len(want_na)})",
                    na == want_na)
        return {"cells": len(cells), "errors": len(errors), "na": len(na), "wall_s": wall,
                "claims": self.um_claims(harness, cells)}

    def um_platform_cells(self, harness, platform, variants, regimes) -> dict:
        """Every app x ``variants`` x ``regimes`` on ``platform``: the cells
        and the wall time."""
        t0 = time.perf_counter()
        cells = [harness.run_cell(app, v, platform, r) for app in harness.WORKLOADS
                 for v in variants for r in regimes]
        return {"cells": cells, "wall_s": time.perf_counter() - t0}

    def um_rows(self, label, cells, variants, regimes) -> dict:
        """Print total_s and the four-way breakdown of each app under
        ``variants``; return {app: {variant: {regime: total_s}}}."""
        by = {(c.app, c.variant, c.regime): c for c in cells}
        out = {}
        for app in dict.fromkeys(c.app for c in cells):
            for v in variants:
                parts = []
                for r in regimes:
                    rep = by[(app, v, r)].report
                    out.setdefault(app, {}).setdefault(v, {})[r] = (
                        None if rep is None else rep.total_s)
                    parts.append(f"{r} N/A" if rep is None else (
                        f"{r} total_s={rep.total_s:.6g} (compute {rep.compute_s:.6g} "
                        f"fault_stall {rep.fault_stall_s:.6g} htod {rep.htod_s:.6g} "
                        f"dtoh {rep.dtoh_s:.6g})"))
                print(f"um {label} {app} {v}: " + "; ".join(parts) + f" [{self.card}]")
        return out

    def um_constants(self, H100_HOST) -> dict:
        """(c) The card's own constants beside H100_HOST's: the memory, the
        pinned host->device rate movement_path measured, a device copy rate
        (bytes read plus written) and the fp32 rate of main_path's SGEMM."""
        torch = self.torch
        n = COPY_BYTES // 4
        a = torch.ones(n, device=DEVICE)
        b = torch.empty_like(a)
        d2d = 2 * COPY_BYTES / (self.time_ms(lambda: b.copy_(a), reps=COPY_REPS) / 1e3)
        del a, b
        gemm = next(r for r in self.rows if r["name"] == "matmul")
        gn = gemm["shape"][0]
        measured = {
            "device_mem_gb": torch.cuda.get_device_properties(0).total_memory / GB,
            "link_bw_gbs": self.rates["h2d_pinned"] / GB,
            "device_bw_gbs": d2d / GB,
            "device_flops_tps": 2 * gn**3 / (gemm["ms"] / 1e3) / 1e12,
        }
        sources = {"device_mem_gb": "total_memory",
                   "link_bw_gbs": "h2d_pinned, 256 MiB (movement_path)",
                   "device_bw_gbs": "device copy_, 256 MiB, read + written",
                   "device_flops_tps": f"SGEMM n={gn} (main_path, 3xTF32)"}
        out = {}
        for key, got in measured.items():
            sheet = getattr(H100_HOST, key)
            out[key] = {"measured": got, "data_sheet": sheet, "ratio": got / sheet,
                        "source": sources[key]}
            print(f"um constant {key}: measured {got:.6g} ({sources[key]}) vs "
                  f"data sheet {sheet:g}, ratio {got / sheet:.4f} (GB = 2^30 B; "
                  f"[{self.card}])")
        return out

    def um_kernel_ratios(self, harness, UMSimulator, get_strategy, platforms) -> list:
        """The simulator's compute_s for one iteration of the BS, cuBLAS and
        FDTD3d workloads sized to what main_path ran, beside the kernel's
        measured ms."""
        totals = {"bs": lambda shp: 20 * shp[0], "cublas": lambda shp: 12 * shp[0] ** 2,
                  "fdtd3d": lambda shp: 8 * math.prod(shp) + 4096}
        out = []
        for name, app in UM_KERNELS:
            row = next(r for r in self.rows if r["name"] == name)
            wl = harness.WORKLOADS[app](totals[app](row["shape"]), iters=1)
            entry = {"kernel": name, "app": app, "shape": row["shape"], "ms": row["ms"]}
            for label, p in platforms.items():
                sim = UMSimulator(p)
                get_strategy("explicit").lower(wl, sim)
                sim_ms = sim.finish().compute_s * 1e3
                entry[label] = {"sim_ms": sim_ms, "measured_over_sim": row["ms"] / sim_ms}
                print(f"um kernel {name} {tuple(row['shape'])}: measured {row['ms']:.4f} ms, "
                      f"simulated on {label} {sim_ms:.4f} ms, ratio "
                      f"{row['ms'] / sim_ms:.4f} [{self.card}]")
            out.append(entry)
        return out

    def um_examples(self, quickstart, um_advise_tour, oversubscribe_demo) -> dict:
        """(d) The quickstart (its BS on the card), the advise tour and the
        demo's section 4."""
        k = self.kernels
        self.reset_counts()
        qs = quickstart.main([])
        launches = self.counters["black_scholes"].launches
        self.expect(f"quickstart section 3 launched the BS kernel ({launches})", launches > 0)
        bs = qs["bs"]
        self.expect("quickstart ran on the card", bs["call"].is_cuda)
        cr, pr = k.black_scholes(bs["s"], bs["x"], bs["t"], use_kernel=False)
        err = max(self.check("quickstart bs call", bs["call"], cr, 1e-4),
                  self.check("quickstart bs put", bs["put"], pr, 1e-4))
        tour = um_advise_tour.main([])
        print("=" * 72)
        print("oversubscribe_demo section 4: the same oversubscription on the "
              "paper's Intel-Volta (simulated)")
        demo = oversubscribe_demo.volta_oversubscription()
        return {"quickstart_bs_launches": launches, "quickstart_bs_max_abs_err": err,
                "quickstart_plans": {a: [p["device_gb"], p["fits"]]
                                     for a, p in qs["plans"].items()},
                "tour_speedups": {" ".join(key): x for key, x in tour["speedups"].items()},
                "demo_total_s": {v: r.total_s for v, r in demo.items()}}

    def um_path(self, quickstart, um_advise_tour, oversubscribe_demo):
        """The UM simulator and the sweep engine: NumPy on the host, held
        here on the chip's host against the paper's findings, with the
        card's measured constants beside the H100 platform's."""
        from repro_torch.core import UMSimulator
        from repro_torch.umbench import harness
        from repro_torch.umbench import platforms as plat
        from repro_torch.umbench.variants import get_strategy

        print("== the UM simulator and sweep engine (um_path)")
        t0 = time.perf_counter()
        sweep = self.um_sweep(harness, plat)

        h100 = self.um_platform_cells(harness, "h100-host", harness.EXTENDED_VARIANTS,
                                      harness.EXTENDED_REGIMES)
        errors = [c for c in h100["cells"] if c.error is not None]
        self.expect(f"um h100-host: {len(h100['cells'])} cells, {len(errors)} errors in "
                    f"{h100['wall_s']:.3f} s [{self.card}]",
                    len(h100["cells"]) == 288 and not errors)
        h100_rows = self.um_rows("h100-host", h100["cells"], UM_BREAKDOWN_VARIANTS,
                                 harness.EXTENDED_REGIMES)

        constants = self.um_constants(plat.H100_HOST)
        measured = dataclasses.replace(
            plat.H100_HOST, name="h100-measured",
            **{key: v["measured"] for key, v in constants.items()})
        meas = self.um_platform_cells(harness, measured, harness.VARIANTS, ("in_memory",))
        meas_rows = self.um_rows("h100-measured", meas["cells"], harness.VARIANTS,
                                 ("in_memory",))
        kernels = self.um_kernel_ratios(harness, UMSimulator, get_strategy,
                                        {"h100-host": plat.H100_HOST,
                                         "h100-measured": measured})
        examples = self.um_examples(quickstart, um_advise_tour, oversubscribe_demo)
        wall = time.perf_counter() - t0
        self.expect(f"um_path within {UM_MAX_S:.0f} s ({wall:.3f} s) [{self.card}]",
                    wall < UM_MAX_S)
        print(json.dumps({"um_path": {
            "card": self.card, "power_limit": self.power_limit, "extended": sweep,
            "h100_host": {"cells": len(h100["cells"]), "errors": len(errors),
                          "wall_s": h100["wall_s"], "total_s": h100_rows},
            "constants": constants,
            "h100_measured": {"wall_s": meas["wall_s"], "total_s": meas_rows},
            "kernels": kernels, "examples": examples, "wall_s": wall}}))

    # -- the serving sweep, the analysis CLI and the benchmark runner -------

    def sweep_sample(self, serving, artifact_rows) -> dict:
        """(a) SWEEP_SAMPLE clean serving cells, serially from the main
        thread, each equal to the committed artifact's row."""
        specs = serving.serving_specs(SWEEP_PATTERNS, SWEEP_PLATFORMS,
                                      tuple(serving.SERVING_REGIMES))
        self.expect(f"sweep serving specs ({len(specs)})", len(specs) == SWEEP_CELLS)
        sample = [specs[(SWEEP_STRIDE * k) % SWEEP_CELLS] for k in range(SWEEP_SAMPLE)]
        axes = ({f"serve_{p}" for p in SWEEP_PATTERNS}, set(SWEEP_PLATFORMS),
                self.strategy_names(), set(serving.SERVING_REGIMES))
        for name, axis, want in zip(("patterns", "platforms", "variants", "regimes"),
                                    range(4), axes):
            got = {s[axis] for s in sample}
            self.expect(f"sweep sample covers the {len(want)} {name}", got == want)
        t0 = time.perf_counter()
        out, mismatched, na = [], 0, 0
        for app, pname, variant, regime, _ in sample:
            cell = serving.run_serving_cell(app, variant, pname, regime)
            row = cell.row()
            want = artifact_rows[(app, pname, variant, regime, "group")]
            same = cell.error is None and all(row.get(f) == want.get(f) for f in SWEEP_FIELDS)
            mismatched += not same
            na += row["total_s"] is None
            got = {f: row.get(f) for f in SWEEP_FIELDS}
            print(f"sweep cell {app} {pname} {variant} {regime}: {got} vs artifact "
                  f"{ {f: want.get(f) for f in SWEEP_FIELDS} } {'ok' if same else 'FAIL'}")
            out.append({"cell": [app, pname, variant, regime], **got, "same": same})
        wall = time.perf_counter() - t0
        self.expect(f"sweep sample: {len(sample)} serving cells equal the committed "
                    f"artifact ({mismatched} differ, {na} N/A) in {wall:.3f} s [{self.card}]",
                    mismatched == 0)
        return {"cells": len(sample), "mismatched": mismatched, "na": na, "wall_s": wall,
                "rows": out}

    @staticmethod
    def strategy_names() -> set:
        from repro_torch.umbench.variants import strategy_names
        return set(strategy_names())

    def sweep_h100(self, serving, plat) -> dict:
        """(b) Every variant serving the poisson trace at kv_150 on
        h100-host: no error cell, N/A exactly where the platform gate fails."""
        from repro_torch.umbench.variants import get_strategy
        p = plat.PLATFORMS["h100-host"]
        t0 = time.perf_counter()
        cells = [serving.run_serving_cell("poisson", v, "h100-host", "kv_150")
                 for v in sorted(self.strategy_names())]
        wall = time.perf_counter() - t0
        errors = [c.variant for c in cells if c.error is not None]
        na = {c.variant for c in cells if c.report is None}
        gated = {c.variant for c in cells if not get_strategy(c.variant).available(p)}
        self.expect(f"sweep h100-host: {len(cells)} cells, errors {errors} in "
                    f"{wall:.3f} s [{self.card}]", len(cells) == 12 and not errors)
        self.expect(f"sweep h100-host N/A {sorted(na)} exactly at the gate {sorted(gated)}",
                    na == gated and bool(gated))
        out = {}
        for c in cells:
            r = c.report
            out[c.variant] = None if r is None else {
                "goodput_rps": r.goodput_rps, "ttft_p99_s": r.ttft_p99_s,
                "e2e_p99_s": r.e2e_p99_s, "completed": r.completed,
                "evictions": r.sim.n_evictions, "total_s": r.total_s}
            print(f"sweep h100-host poisson kv_150 {c.variant}: " + (
                "N/A" if r is None else
                f"goodput {r.goodput_rps:.6g} rps, ttft_p99 {r.ttft_p99_s:.6g} s, "
                f"e2e_p99 {r.e2e_p99_s:.6g} s, completed {r.completed}, "
                f"evictions {r.sim.n_evictions}") + f" [{self.card}]")
            if r is not None:
                self.expect(f"sweep h100-host {c.variant} served every request",
                            r.completed == r.n_requests)
        return {"cells": len(cells), "na": sorted(na), "wall_s": wall, "variants": out}

    def sweep_runner(self, bench_run, artifact_rows) -> dict:
        """(e) ``bench.run --fast --json --out <tmpdir>``: the five claims
        met, every cell equal to the committed artifact's, and the committed
        artifact untouched."""
        import contextlib
        import hashlib
        import io
        import tempfile

        artifact = ROOT / SWEEP_ARTIFACT
        before = hashlib.sha256(artifact.read_bytes()).hexdigest()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            with contextlib.redirect_stdout(buf):
                rc = bench_run.main(["--fast", "--json", "--out", tmp])
            payload = json.loads((Path(tmp) / bench_run.BENCH_PATH).read_text())
            leftover = sorted(q.name for q in Path(tmp).iterdir())
        wall = time.perf_counter() - t0
        after = hashlib.sha256(artifact.read_bytes()).hexdigest()
        lines = buf.getvalue().splitlines()
        self.expect(f"sweep runner exit code {rc}", rc == 0)
        self.expect(f"sweep runner left {leftover} in its directory",
                    leftover == [bench_run.BENCH_PATH])
        claims = [ln.split(",") for ln in lines if ln.startswith("claims,")]
        measured = {c[1]: float(c[2].rstrip("x")) for c in claims}
        limits = {"intel_oversub_advise_bs": lambda x: x >= 1.1,
                  "p9_inmem_advise_cg": lambda x: x >= 1.3,
                  "p9_oversub_advise_bs": lambda x: x <= 0.5,
                  "intel_inmem_prefetch_cg": lambda x: x >= 1.5,
                  "p9_inmem_prefetch_cg": lambda x: x < measured.get(
                      "intel_inmem_prefetch_cg", 0.0)}
        for c in claims:
            print(f"sweep runner {','.join(c)}")
        met = [k for k, ok in limits.items() if k in measured and ok(measured[k])]
        self.expect(f"sweep runner: {len(met)} of 5 paper claims met", len(met) == 5
                    and len(claims) == 5)
        keyed = [r for r in payload["cells"]
                 if (r["app"], r["platform"], r["variant"], r["regime"],
                     r["granularity"]) in artifact_rows]
        differ = [r for r in keyed if r != artifact_rows[
            (r["app"], r["platform"], r["variant"], r["regime"], r["granularity"])]]
        self.expect(f"sweep runner: {len(keyed)} of {len(payload['cells'])} cells keyed in "
                    f"the committed artifact, {len(differ)} differ",
                    len(keyed) == len(payload["cells"]) == 240 and not differ)
        self.expect(f"sweep runner left {SWEEP_ARTIFACT} unchanged ({before[:12]})",
                    before == after)
        print(f"sweep runner: {lines[-1] if lines else ''} in {wall:.3f} s [{self.card}]")
        return {"rc": rc, "claims": measured, "cells": len(payload["cells"]),
                "differ": len(differ), "matrix_240_wall_s": payload["matrix_240_wall_s"],
                "host": payload["host"], "wall_s": wall}

    def sweep_path(self, serving, plat, analysis_main, kv_serving_demo, bench_run,
                   arch_step_rows):
        """The serving sweep, the analysis CLI, the serving demo, the
        benchmark runner and the reduced configs' step timings on the card."""
        print("== the serving sweep, analysis CLI and benchmark runner (sweep_path)")
        t0 = time.perf_counter()
        rows = json.loads((ROOT / SWEEP_ARTIFACT).read_text())["cells"]
        artifact_rows = {(r["app"], r["platform"], r["variant"], r["regime"],
                          r["granularity"]): r for r in rows}
        sample = self.sweep_sample(serving, artifact_rows)
        h100 = self.sweep_h100(serving, plat)

        t1 = time.perf_counter()
        rc = analysis_main(["--contracts", "--serving"])
        cli_s = time.perf_counter() - t1
        self.expect(f"sweep analysis CLI --contracts --serving exit code {rc} "
                    f"({cli_s:.3f} s)", rc == 0)

        t1 = time.perf_counter()
        demo = kv_serving_demo.main([])
        demo_s = time.perf_counter() - t1
        served = [r for tiers in demo.values() for r in tiers.values() if r is not None]
        self.expect(f"sweep serving demo: {len(served)} of 8 tiers served "
                    f"({demo_s:.3f} s)", len(demo) == 2 and len(served) == 8
                    and all(r.completed == r.n_requests for r in served))

        runner = self.sweep_runner(bench_run, artifact_rows)

        t1 = time.perf_counter()
        captures = {}
        lm_rows = arch_step_rows(device=DEVICE, capture_s=captures)
        lm_s = time.perf_counter() - t1
        steps, capture_s = {}, {}
        for row in lm_rows[1:]:
            _, arch, op, us, _ = row.split(",")
            steps.setdefault(arch, {})[op] = float(us)
            capture_s.setdefault(arch, {})[op] = captures.get((arch, op))
            print(f"sweep {row} (a CUDA graph's replay; capture {captures.get((arch, op))} s) "
                  f"[{self.card}]")
        self.expect(f"sweep arch_step_rows: {len(steps)} configs on the card, every row timed "
                    f"from a CUDA graph's replays ({len(captures)} captures, "
                    f"{sum(captures.values()):.3f} s of {lm_s:.3f} s)",
                    len(lm_rows) == 21 and len(steps) == 10 and len(captures) == 20
                    and all(v > 0 for ops in steps.values() for v in ops.values()))

        wall = time.perf_counter() - t0
        self.expect(f"sweep_path within {SWEEP_MAX_S:.0f} s ({wall:.3f} s) [{self.card}]",
                    wall < SWEEP_MAX_S)
        print(json.dumps({"sweep_path": {
            "card": self.card, "power_limit": self.power_limit, "sample": sample,
            "h100_host": h100, "cli": {"rc": rc, "wall_s": cli_s},
            "demo": {"served": len(served), "wall_s": demo_s}, "runner": runner,
            "arch_step_us": steps, "arch_step_capture_s": capture_s,
            "arch_step_wall_s": lm_s, "wall_s": wall}}))

    # -- the training path -------------------------------------------------

    def device_batch(self, batch_np) -> dict:
        return {k: self.torch.from_numpy(v).to(DEVICE) for k, v in batch_np.items()}

    @staticmethod
    def train_bound(cfg, n_params, moment_bytes) -> dict:
        """A step's least time: 6 x the matrix parameters (the tied head
        included) x the tokens, and causal QK^T and PV forward and backward
        (3 x 4 Hq Dh S(S+1)/2 L B), at the bf16 peak, remat's recompute not
        counted; then the optimizer's bytes at the memory rate: each
        gradient read for the norm and for the update, the parameter
        written, the fp32 master and both moments read and written."""
        mats = (cfg.num_layers * (cfg.attn_params_per_layer() + cfg.ffn_params_per_layer())
                + cfg.padded_vocab * cfg.d_model)
        tokens = TRAIN_B * TRAIN_S
        pairs = TRAIN_S * (TRAIN_S + 1) // 2
        flops = {"matrix": 6 * mats * tokens,
                 "attention": 12 * cfg.num_heads * cfg.head_dim * pairs * cfg.num_layers * TRAIN_B}
        compute_ms = sum(flops.values()) / PEAK_BF16_FLOPS * 1e3
        opt_bytes = n_params * (2 + 2 + 2 + 8 + 4 * moment_bytes)
        opt_ms = opt_bytes / PEAK_BYTES_PER_S * 1e3
        return {"bound_flops": flops, "bound_compute_ms": compute_ms,
                "bound_optimizer_bytes": opt_bytes, "bound_optimizer_ms": opt_ms,
                "bound_ms": compute_ms + opt_ms}

    def train_full(self, tf) -> dict:
        """launch.train.train at full width and depth with the state on the
        card, through the compiled step (a ``GraphTrainStep``): ms a step,
        tokens/s, peak memory and the capture's ms; one warm graph step
        under torch.profiler (host launch calls, busy share); then, the
        graph released, the optimizer (clip and apply_updates) timed apart
        and one eager step (the step's body) timed and profiled."""
        import tempfile

        torch = self.torch
        from repro_torch.configs import ShapeConfig, get_config
        from repro_torch.data import DataConfig, synthetic_batches
        from repro_torch.launch.step import GraphTrainStep, _adamw_cfg
        from repro_torch.launch.train import train
        from repro_torch.optim import apply_updates, clip_by_global_norm, warmup_cosine

        arch = get_config(TRAIN_MODEL)
        cfg = arch.model
        shape = ShapeConfig("train", TRAIN_S, TRAIN_B, "train")
        self.start_app(f"train {TRAIN_MODEL} full width B={TRAIN_B} S={TRAIN_S}, "
                       f"{TRAIN_STEPS} steps, the state on the card")
        with TrainHeld(self) as held, tempfile.TemporaryDirectory() as d:
            (params, opt), report = train(TRAIN_MODEL, reduced=False, steps=TRAIN_STEPS,
                                          batch=TRAIN_B, seq=TRAIN_S, ckpt_dir=d,
                                          checkpoint_every=10**6, device=DEVICE)
            torch.cuda.synchronize()
            peak, reserved = torch.cuda.max_memory_allocated(), torch.cuda.max_memory_reserved()
            step = held.step
            self.expect("train() trains through a GraphTrainStep that captured its graph",
                        isinstance(step, GraphTrainStep) and step.graph is not None)
            batch = self.device_batch(next(synthetic_batches(cfg, shape, DataConfig(seed=0))))
            graph_prof = self.profile_calls((("train_step graph", lambda: step(
                params, opt, batch, TRAIN_STEPS), 1),), top=12)["train_step graph"]
            body, capture_ms = step.body, step.capture_ms
            del step
        counts = {name: fn.launches for name, fn in self.counters.items()}
        calls = graph_prof["host_launch_calls"]
        self.expect(f"a warm graph train step makes {calls:g} host launch calls "
                    f"{graph_prof['host_launch_calls_by_api']} (<= {TRAIN_GRAPH_MAX_CALLS})",
                    calls <= TRAIN_GRAPH_MAX_CALLS)
        self.free()
        ms = statistics.median(report.step_times[1:]) * 1e3
        n_params = sum(p.numel() for p in params.parameters())
        names, leaves = zip(*params.named_parameters())
        loss = tf.loss_fn(params, batch, cfg, remat=arch.train.remat)
        grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
        del loss
        acfg = _adamw_cfg(arch, None)
        lr = warmup_cosine(TRAIN_STEPS, peak_lr=arch.train.learning_rate,
                           warmup_steps=arch.train.warmup_steps, total_steps=TRAIN_STEPS)

        def optimizer():
            clip_by_global_norm(grads, arch.train.grad_clip)
            apply_updates(params, grads, opt, acfg, lr)

        opt_ms = self.time_ms(optimizer)
        del grads
        self.free()
        n = torch.tensor(TRAIN_STEPS, dtype=torch.int32, device=DEVICE)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        body(params, opt, batch, n)
        torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t0) * 1e3
        eager_peak = torch.cuda.max_memory_allocated()
        prof = self.profile_calls((("train_step eager", lambda: body(params, opt, batch, n),
                                    1),), top=12)["train_step eager"]
        del params, opt, batch, leaves, body
        self.free()
        bound = self.train_bound(cfg, n_params, 4)
        out = {"model": TRAIN_MODEL, "batch": TRAIN_B, "seq": TRAIN_S, "steps": TRAIN_STEPS,
               "params": n_params, "losses": report.losses, "step_ms": report.step_times,
               "ms_per_step": ms, "tokens_per_s": TRAIN_B * TRAIN_S / ms * 1e3,
               "capture_ms": capture_ms, "eager_ms_per_step": eager_ms,
               "max_memory_allocated": peak, "max_memory_reserved": reserved,
               "eager_max_memory_allocated": eager_peak, "optimizer_ms": opt_ms,
               "optimizer_share": opt_ms / ms, **bound, "share": bound["bound_ms"] / ms,
               "profile": prof, "graph_profile": graph_prof, "kernel_launches": counts}
        print(f"train {TRAIN_MODEL}: {ms:.1f} ms a step as a CUDA graph (median of steps "
              f"1-{TRAIN_STEPS - 1}; capture {capture_ms:.1f} ms in step 0), one eager step "
              f"{eager_ms:.1f} ms, {out['tokens_per_s']:.0f} tokens/s, bound "
              f"{bound['bound_ms']:.1f} ms ({bound['bound_compute_ms']:.1f} compute + "
              f"{bound['bound_optimizer_ms']:.1f} optimizer; share {out['share']:.3f}), "
              f"optimizer {opt_ms:.1f} ms ({out['optimizer_share']:.3f} of a step); host launch "
              f"calls a step {calls:g} graph / {prof['host_launch_calls']:g} eager, busy "
              f"{graph_prof['device_busy_share'] or float('nan'):.3f} / "
              f"{prof['device_busy_share'] or float('nan'):.3f}; peak {peak} bytes allocated "
              f"({reserved} reserved), an eager step's {eager_peak}; losses {report.losses}; "
              f"the model calls the plain attention, kernel launches {counts} [{self.card}]")
        return out

    def train_graph_check(self) -> dict:
        """At full depth, TRAIN_GRAPH_STEPS steps from TRAIN_CUT_AT through
        the graph, then as many eager steps from the same seed and batches,
        one run after the other under deterministic algorithms: the params
        bit for bit and every state tensor's digest alike."""
        import itertools

        from repro_torch.configs import ShapeConfig, get_config
        from repro_torch.data import DataConfig, synthetic_batches

        arch = get_config(TRAIN_MODEL)
        shape = ShapeConfig("train", TRAIN_S, TRAIN_B, "train")
        print(f"== train graph check: {TRAIN_MODEL} full width and depth, {TRAIN_GRAPH_STEPS} "
              "steps through the graph against as many eager steps")
        self.free()
        batches = [self.device_batch(b) for b in itertools.islice(
            synthetic_batches(arch.model, shape, DataConfig(seed=1)), TRAIN_GRAPH_STEPS)]
        steps = range(TRAIN_CUT_AT, TRAIN_CUT_AT + TRAIN_GRAPH_STEPS)
        with deterministic(self.torch):
            rec, graph, eager = TrainHeld(self).check(
                "full depth", arch, shape, None, batches, steps, seed=0, exact=False)
        del graph, eager, batches
        self.free()
        return rec

    def train_host(self, init_params) -> dict:
        """The same model and batches under a plan with int8 moments and the
        optimizer state in pinned host memory, through build_train_step (a
        ``GraphTrainStep``, whose offload writes the pinned state in place):
        ms a step, the pinned allocator after every step, one warm graph step
        under torch.profiler, one eager step (the step's body, the graph
        released), fetch and in-place offload ms, peak memory."""
        torch = self.torch
        from repro_torch.checkpoint.checkpointer import tree_leaves
        from repro_torch.configs import MeshConfig, ShapeConfig, get_config
        from repro_torch.core.advise import MemorySpace
        from repro_torch.core.residency import MemoryBudget, ResidencyPlan
        from repro_torch.core.streaming import fetch_params, offload_into, offload_params
        from repro_torch.data import DataConfig, synthetic_batches
        from repro_torch.launch.step import GraphTrainStep, _adamw_cfg, build_train_step
        from repro_torch.optim import init_state

        arch = get_config(TRAIN_MODEL)
        cfg = arch.model
        shape = ShapeConfig("train", TRAIN_S, TRAIN_B, "train")
        plan = ResidencyPlan(arch.name, shape.name, MeshConfig(), MemoryBudget(),
                             opt_space=MemorySpace.HOST, int8_moments=True,
                             remat=arch.train.remat)
        self.start_app(f"train {TRAIN_MODEL} full width, {TRAIN_HOST_STEPS} steps, int8 "
                       "moments and the optimizer state in pinned host memory")
        torch.cuda.reset_peak_host_memory_stats()
        pinned_before = torch.cuda.host_memory_stats().get("allocated_bytes.current")
        params = init_params(cfg, torch.Generator(device=DEVICE).manual_seed(0), DEVICE)
        state = offload_params(init_state(params, _adamw_cfg(arch, plan)), DEVICE)
        host_bytes = sum(x.numel() * x.element_size() for x in tree_leaves(state))
        self.expect("the host plan's optimizer state is in pinned host memory",
                    all(x.is_pinned() for x in tree_leaves(state)))
        step = build_train_step(arch, shape, None, plan, total_steps=TRAIN_STEPS, device=DEVICE)
        gen = synthetic_batches(cfg, shape, DataConfig(seed=0))
        losses, times = [], []
        pinned_steps = [torch.cuda.host_memory_stats().get("allocated_bytes.current")]
        for i in range(TRAIN_HOST_STEPS):
            batch = self.device_batch(next(gen))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, metrics = step(params, state, batch, i)
            losses.append(float(metrics["loss"]))
            times.append(time.perf_counter() - t0)
            pinned_steps.append(torch.cuda.host_memory_stats().get("allocated_bytes.current"))
            del metrics
        peak = torch.cuda.max_memory_allocated()
        self.expect(f"the host plan trains through a GraphTrainStep; its pinned allocator is "
                    f"flat after step 0 (allocated bytes before and after each step: "
                    f"{pinned_steps})",
                    isinstance(step, GraphTrainStep) and len(set(pinned_steps[1:])) == 1)
        graph_prof = self.profile_calls((("train_step host graph", lambda: step(
            params, state, batch, TRAIN_HOST_STEPS), 1),))["train_step host graph"]
        calls = graph_prof["host_launch_calls"]
        self.expect(f"a warm graph step of the host plan makes {calls:g} host launch calls "
                    f"{graph_prof['host_launch_calls_by_api']} (<= {TRAIN_GRAPH_MAX_CALLS})",
                    calls <= TRAIN_GRAPH_MAX_CALLS)
        pinned = {k: v for k, v in torch.cuda.host_memory_stats().items()
                  if k.startswith("allocated_bytes.") or k.startswith("num_host_alloc")}
        pinned["allocated_bytes.current_before"] = pinned_before
        pinned["allocated_bytes.current_by_step"] = pinned_steps
        body, capture_ms = step.body, step.capture_ms
        del step
        self.free()
        n = torch.tensor(TRAIN_HOST_STEPS, dtype=torch.int32, device=DEVICE)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        body(params, state, batch, n)
        torch.cuda.synchronize()
        eager_ms = (time.perf_counter() - t0) * 1e3
        fetch_ms, offload_ms = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            on_card = fetch_params(state, DEVICE)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            offload_into(state, on_card)
            torch.cuda.synchronize()
            offload_ms.append((time.perf_counter() - t1) * 1e3)
            fetch_ms.append((t1 - t0) * 1e3)
            del on_card
        n_params = sum(p.numel() for p in params.parameters())
        del params, state, batch, body
        self.free()
        ms = statistics.median(times[1:]) * 1e3
        bound = self.train_bound(cfg, n_params, 1)
        link = host_bytes / self.rates["h2d_pinned"] * 1e3 + host_bytes / self.rates["d2h_pinned"] * 1e3
        out = {"steps": TRAIN_HOST_STEPS, "losses": losses, "step_ms": [t * 1e3 for t in times],
               "ms_per_step": ms, "tokens_per_s": TRAIN_B * TRAIN_S / ms * 1e3,
               "capture_ms": capture_ms, "eager_ms_per_step": eager_ms,
               "max_memory_allocated": peak, "host_state_bytes": host_bytes,
               "pinned_allocator": pinned, "fetch_ms": statistics.median(fetch_ms),
               "offload_ms": statistics.median(offload_ms), "graph_profile": graph_prof,
               **bound, "link_ms_at_measured_copy_rates": link,
               "bound_ms_with_link": bound["bound_ms"] + link,
               "share": (bound["bound_ms"] + link) / ms}
        print(f"train host plan: {ms:.1f} ms a step as a CUDA graph (capture {capture_ms:.1f} "
              f"ms), one eager step {eager_ms:.1f} ms, fetch {out['fetch_ms']:.1f} ms, offload "
              f"in place {out['offload_ms']:.1f} ms of {host_bytes} bytes, bound "
              f"{bound['bound_ms']:.1f} + link {link:.1f} ms (share {out['share']:.3f}), host "
              f"launch calls a step {calls:g}, busy "
              f"{graph_prof['device_busy_share'] or float('nan'):.3f}, peak {peak} bytes, pinned "
              f"{pinned}, losses {losses} [{self.card}]")
        return out

    def train_cut_checks(self, tf, init_params) -> dict:
        """On a 2-layer cut of the model at full width: the compiled step
        against its eager body (bit for bit, the state on the card and on
        the host, fp32 and int8 moments, and the planner's last escalation:
        int8 moments on the host under remat "offload"; the step buffer left
        unfilled must fail; other params refused), the optimizer on the host
        against the card (bit for bit), "offload" against "full" (bit for
        bit), bf16 against fp32, and apply_updates against itself in fp64
        on the CPU, with one fault."""
        import dataclasses
        import itertools

        torch = self.torch
        from repro_torch.configs import MeshConfig, ShapeConfig, get_config
        from repro_torch.core.advise import MemorySpace
        from repro_torch.core.residency import MemoryBudget, ResidencyPlan
        from repro_torch.data import DataConfig, synthetic_batches

        arch = get_config(TRAIN_MODEL)
        arch = dataclasses.replace(arch, model=dataclasses.replace(
            arch.model, num_layers=TRAIN_CUT_LAYERS))
        cfg = arch.model
        shape = ShapeConfig("cut", TRAIN_S, TRAIN_B, "train")
        print(f"== train checks: {TRAIN_MODEL} cut to {TRAIN_CUT_LAYERS} layers, full width, "
              f"B={TRAIN_B} S={TRAIN_S}")
        self.free()
        batches = [self.device_batch(b) for b in itertools.islice(
            synthetic_batches(cfg, shape, DataConfig(seed=1)), TRAIN_CUT_STEPS)]

        def fresh(seed):
            return init_params(cfg, torch.Generator(device=DEVICE).manual_seed(seed), DEVICE)

        out = {"host_vs_device": {}, "graph_vs_eager": {}, "seconds": {}}
        t0 = time.perf_counter()
        held = TrainHeld(self)
        steps = range(TRAIN_CUT_AT, TRAIN_CUT_AT + TRAIN_CUT_STEPS)
        with deterministic(torch):
            for int8 in (False, True):
                finals = []
                label = "int8" if int8 else "fp32"
                for space in (MemorySpace.DEVICE, MemorySpace.HOST):
                    plan = ResidencyPlan(cfg.name, shape.name, MeshConfig(), MemoryBudget(),
                                         opt_space=space, int8_moments=int8,
                                         remat=arch.train.remat)
                    where = "host" if space is MemorySpace.HOST else "card"
                    rec, graph, _ = held.check(f"c: {label} moments, the state on the {where}",
                                               arch, shape, plan, batches, steps, seed=1,
                                               refuse=not int8 and where == "card")
                    out["graph_vs_eager"][f"{label}_{where}"] = rec
                    finals.append(graph["leaves"])
                    del graph, _
                differ = sum(not torch.equal(x, y) for x, y in zip(*finals))
                out["host_vs_device"][label] = differ
                self.expect(f"c: {TRAIN_CUT_STEPS} steps with the optimizer on the host == on the "
                            f"card, {label} moments, bit for bit ({differ} of {len(finals[0])} "
                            "tensors differ)", differ == 0)
                host_full = finals[1] if int8 else None
                del finals
            out["graph_vs_eager"]["int8_host_offload"] = self.train_offload_plan(
                held, arch, shape, batches, steps, host_full)
            del host_full
            # the graph's fault: the lr moves from step to step in the warmup
            warm = range(1, 1 + TRAIN_CUT_STEPS)
            rec, _, eager = held.check("c: fp32 moments, the state on the card, warmup steps",
                                       arch, shape, None, batches, warm, seed=1)
            out["graph_vs_eager"]["fp32_card_warmup"] = rec
            faulty = held.run(arch, shape, None, batches, warm, seed=1, mode="fault")
            apart, of, worst = held.differ(faulty, eager)
            fault = faulty["fault"]
            out["fault"] = {"fault": fault, "tensors_differing": apart, "max_abs_diff": worst}
            self.expect(f"c: the comparison rejects graph steps with {fault} ({apart} of {of} "
                        f"tensors differ from eager, max |diff| {worst:.3e})", apart > 0)
            del _, eager, faulty
        self.free()
        out["seconds"]["c"] = time.perf_counter() - t0

        params = fresh(2)
        gap = train_bf16_gap(tf, params, cfg, batches[0])
        del params
        self.free()
        out["bf16_vs_fp32"] = {**gap, "limits": [TRAIN_BF16_LOSS_REL, TRAIN_BF16_GRAD_REL]}
        self.expect(f"d: bf16 vs fp32 loss gap {gap['loss']:.3e} <= {TRAIN_BF16_LOSS_REL}",
                    gap["loss"] <= TRAIN_BF16_LOSS_REL)
        self.expect(f"d: bf16 vs fp32 gradients rel L2 {gap['grads']:.4e} <= "
                    f"{TRAIN_BF16_GRAD_REL}", gap["grads"] <= TRAIN_BF16_GRAD_REL)
        out["seconds"]["d"] = time.perf_counter() - t0 - out["seconds"]["c"]
        out["update_vs_fp64"] = self.update_vs_fp64(tf, fresh(3), arch, batches[0])
        out["seconds"]["e_f"] = time.perf_counter() - t0 - sum(out["seconds"].values())
        del batches
        self.free()
        return out

    def train_offload_plan(self, held, arch, shape, batches, steps, host_full) -> dict:
        """The planner's last escalation on the cut: int8 moments, the state
        in pinned host memory and remat "offload".  build_train_step must
        give it a GraphTrainStep (``TrainHeld.run`` raises otherwise); the
        graph against its eager body bit for bit; the graph's final tensors
        bit for bit those of the same plan under "full" (``host_full``); a
        warm graph step in at most TRAIN_GRAPH_MAX_CALLS host launch calls;
        the pinned allocator flat after step 0."""
        from repro_torch.configs import MeshConfig
        from repro_torch.core.advise import MemorySpace
        from repro_torch.core.residency import MemoryBudget, ResidencyPlan

        plan = ResidencyPlan(arch.model.name, shape.name, MeshConfig(), MemoryBudget(),
                             opt_space=MemorySpace.HOST, int8_moments=True, remat="offload")
        rec, graph, _ = held.check("c: int8 moments, the state on the host, remat offload",
                                   arch, shape, plan, batches, steps, seed=1, probe=True)
        apart = sum(not x.equal(y) for x, y in zip(graph["leaves"], host_full, strict=True))
        rec["tensors_apart_from_full"] = apart
        self.expect(f"c: remat offload == remat full, int8 moments on the host, "
                    f"{TRAIN_CUT_STEPS} graph steps bit for bit ({apart} of {len(host_full)} "
                    "tensors differ)", apart == 0)
        prof, pinned = graph["profile"], graph["pinned_by_step"]
        calls = prof["host_launch_calls"]
        self.expect(f"c: a warm graph step under remat offload on the host plan makes "
                    f"{calls:g} host launch calls {prof['host_launch_calls_by_api']} (<= "
                    f"{TRAIN_GRAPH_MAX_CALLS}) [{self.card}]", calls <= TRAIN_GRAPH_MAX_CALLS)
        self.expect(f"c: under remat offload on the host plan the pinned allocator is flat "
                    f"after step 0 (allocated bytes before and after each step: {pinned})",
                    len(set(pinned[1:])) == 1)
        del graph, _
        self.free()
        return rec

    def update_vs_fp64(self, tf, params, arch, batch) -> dict:
        """apply_updates on the card from a state one step old, against the
        same call in fp64 on the CPU from the same values, made a scale
        group at a time so that the fp64 copies stay small; for fp32
        moments also the card's call with the bias correction dropped,
        which must fail."""
        torch = self.torch
        from repro_torch.optim import adamw

        cfg = arch.model
        names, leaves = zip(*params.named_parameters())
        loss = tf.loss_fn(params, batch, cfg)
        grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
        del loss
        lr = torch.tensor(arch.train.learning_rate, dtype=torch.float32)
        initial = {n: p.detach().clone() for n, p in params.named_parameters()}

        def clone(tree):
            return {k: clone(v) if isinstance(v, dict) else v.clone() for k, v in tree.items()}

        def wide(x):  # a CPU copy: fp leaves in fp64, int8 codes and the step as they are
            x = x.to(torch.float64) if x.is_floating_point() else x
            return x.to("cpu", copy=True)

        def card_step(start, start_params, fault=False):
            with torch.no_grad():
                for n, p in params.named_parameters():
                    p.copy_(start_params[n])
            state = clone(start)
            real = adamw._corrections
            if fault:  # f: the bias correction dropped
                adamw._corrections = lambda step, cfg, dtype: (
                    torch.ones((), dtype=dtype, device=step.device),) * 2
            try:
                adamw.apply_updates(params, grads, state, acfg, lr)
            finally:
                adamw._corrections = real
            return state

        out = {}
        for int8 in (False, True):
            label = "int8" if int8 else "fp32"
            acfg = adamw.AdamWConfig(weight_decay=arch.train.weight_decay, int8_moments=int8)
            with torch.no_grad():
                for n, p in params.named_parameters():
                    p.copy_(initial[n])
            start = adamw.init_state(params, acfg)
            adamw.apply_updates(params, grads, start, acfg, lr)   # moments of one step
            start_params = {n: p.detach().clone() for n, p in params.named_parameters()}
            got = {"state": card_step(start, start_params)}
            bitcast = all(torch.equal(p, got["state"]["leaves"][n]["master"].to(p.dtype))
                          for n, p in params.named_parameters())
            if not int8:
                got["fault"] = card_step(start, start_params, fault=True)
            found = {k: [0.0, 0, 0] for k in got}  # largest rel error, codes apart, at edges
            cpu_s = 0.0
            for group in adamw.scale_groups(start_params):
                want = {"step": wide(start["step"]), "leaves": {
                    n: {k: wide(v) for k, v in start["leaves"][n].items()} for n in group}}
                t0 = time.perf_counter()
                adamw.apply_updates({n: wide(start_params[n]) for n in group},
                                    {n: wide(grads[n]) for n in group}, want, acfg, lr)
                cpu_s += time.perf_counter() - t0
                # compared on the card, the reference's results in fp64
                want = {n: {k: v.to(DEVICE) for k, v in want["leaves"][n].items()}
                        for n in group}
                edges = (int8_edges({n: start["leaves"][n] for n in group},
                                    {n: grads[n] for n in group}, want, acfg, TRAIN_EDGE)
                         if int8 else None)
                for key, state in got.items():
                    for n in group:
                        for k, x in state["leaves"][n].items():
                            w = want[n][k]
                            if x.dtype == torch.int8:
                                diff = x != w
                                found[key][1] += int(diff.sum())
                                found[key][2] += int((diff & edges[n][k]).sum())
                            else:
                                err = (x.double() - w).abs().max().item()
                                found[key][0] = max(found[key][0],
                                                    err / max(w.abs().max().item(), 1e-30))
                del want, edges
            worst, codes, at_edges = found["state"]
            out[label] = {"max_rel_err": worst, "codes_differing": codes,
                          "codes_differing_at_edges": at_edges, "cpu_fp64_s": cpu_s}
            self.expect(f"e: apply_updates on the card vs fp64 on the CPU, {label} moments: "
                        f"state within {worst:.3e} <= {TRAIN_STATE_RTOL} of each leaf's largest; "
                        f"{codes} int8 codes differ, {at_edges} of them at rounding edges",
                        worst <= TRAIN_STATE_RTOL and codes == at_edges)
            self.expect(f"e: the parameters are their masters in bf16 ({label})", bitcast)
            if not int8:
                fault = found["fault"][0]
                out["fault_no_bias_correction_max_rel_err"] = fault
                self.expect(f"f: the fp64 check rejects apply_updates without the bias "
                            f"correction: {fault:.3e} > {TRAIN_STATE_RTOL}",
                            fault > TRAIN_STATE_RTOL)
            del got, start, start_params
        del params, grads, initial
        return out

    def train_drills(self, init_params) -> dict:
        """The reduced configs on the card: the loss falls over 30 steps; a
        fault at step 12 restarts from step 10's checkpoint and ends near
        an uninterrupted run; a bf16 + fp32 + int8 state survives a
        checkpoint round trip bit for bit."""
        import dataclasses
        import tempfile

        torch = self.torch
        from repro_torch.checkpoint import Checkpointer
        from repro_torch.checkpoint.checkpointer import tree_leaves
        from repro_torch.configs import get_config
        from repro_torch.launch.train import train
        from repro_torch.optim import adamw

        print("== train drills: reduced configs")
        out = {}
        with tempfile.TemporaryDirectory() as d:
            _, rep = train("starcoder2-3b", steps=30, batch=4, seq=64, ckpt_dir=f"{d}/g",
                           checkpoint_every=10, device=DEVICE)
            first, last = statistics.mean(rep.losses[:5]), statistics.mean(rep.losses[-5:])
            out["loss_falls"] = {"first5": first, "last5": last, "losses": rep.losses}
            self.expect(f"g: reduced starcoder2-3b, 30 steps: mean of the last 5 losses {last:.4f}"
                        f" < mean of the first 5 {first:.4f} - 0.05", last < first - 0.05)
            kw = dict(steps=25, batch=4, seq=64, checkpoint_every=5, device=DEVICE)
            _, clean = train("qwen2-7b", ckpt_dir=f"{d}/clean", **kw)
            _, rep = train("qwen2-7b", ckpt_dir=f"{d}/fault", fault_schedule=(12,), **kw)
            err = abs(rep.losses[-1] - clean.losses[-1]) / abs(clean.losses[-1])
            out["restart"] = {"restarts": rep.restarts, "steps_completed": rep.steps_completed,
                              "final_loss": rep.losses[-1], "clean_final_loss": clean.losses[-1],
                              "rel_err": err, "tol": TRAIN_RESTART_RTOL}
            self.expect(f"h: reduced qwen2-7b, fault at step 12: restarts {rep.restarts} == 1, "
                        f"final loss {rep.losses[-1]:.6f} within {err:.2e} <= "
                        f"{TRAIN_RESTART_RTOL} of an uninterrupted run's {clean.losses[-1]:.6f}",
                        rep.restarts == 1 and rep.steps_completed >= 25
                        and err <= TRAIN_RESTART_RTOL)

            cfg = dataclasses.replace(get_config("starcoder2-3b").model.reduce(),
                                      dtype="bfloat16")
            acfg = adamw.AdamWConfig(int8_moments=True)

            def tree(seed):
                params = init_params(cfg, torch.Generator(device=DEVICE).manual_seed(seed), DEVICE)
                state = adamw.init_state(params, acfg)
                grads = {n: torch.randn(p.shape, device=DEVICE).to(p.dtype)
                         for n, p in params.named_parameters()}
                adamw.apply_updates(params, grads, state, acfg, 1e-2)
                return params, state

            saved = tree(4)
            ckpt = Checkpointer(f"{d}/i")
            ckpt.save(1, saved, blocking=True)
            target = tree(5)
            ckpt.restore(1, target)
            pairs = list(zip(tree_leaves(saved), tree_leaves(target)))
            dtypes = sorted({str(x.dtype) for x, _ in pairs})
            same = all(torch.equal(x, y) and y.is_cuda for x, y in pairs)
            out["checkpoint_dtypes"] = dtypes
            self.expect(f"i: a checkpoint of {len(pairs)} tensors ({', '.join(dtypes)}) restores "
                        "onto the card bit for bit", same)
        return out

    def train_path(self, tf, init_params):
        """The training path: starcoder2-3b at full width with the state on
        the card and under the escalated plan, through the compiled step,
        which is held against its eager body at full depth and on the cut;
        checks a-i."""
        seconds = {}
        t0 = time.perf_counter()
        full = self.train_full(tf)
        self.train_full_peak = full["eager_max_memory_allocated"]  # what the dry-run traces
        seconds["full"] = time.perf_counter() - t0
        graph = self.train_graph_check()
        seconds["graph_check"] = time.perf_counter() - t0 - sum(seconds.values())
        # the cut's checks before the host plan, whose pinned blocks stay
        # cached in host memory, beside the CPU's fp64 reference
        cut = self.train_cut_checks(tf, init_params)
        seconds["cut_checks"] = time.perf_counter() - t0 - sum(seconds.values())
        host = self.train_host(init_params)
        seconds["host_plan"] = time.perf_counter() - t0 - sum(seconds.values())
        self.expect(f"a: step 0's loss is the same in both full-width runs "
                    f"({full['losses'][0]!r} == {host['losses'][0]!r})",
                    full["losses"][0] == host["losses"][0])
        finite = all(math.isfinite(x) for x in full["losses"] + host["losses"])
        self.expect("b: the losses of both full-width runs are finite", finite)
        fell = full["losses"][-1] < full["losses"][0]
        if fell:
            self.expect(f"b: the fp32-state run's last loss {full['losses'][-1]:.4f} < its first "
                        f"{full['losses'][0]:.4f}", fell)
        else:
            print(f"b: the warmup's first {TRAIN_STEPS} steps move the loss "
                  f"{full['losses'][0]:.4f} -> {full['losses'][-1]:.4f}; the fall is held "
                  "by g")
        drop = full["max_memory_allocated"] - host["max_memory_allocated"]
        state_bytes = full["params"] * 12  # fp32 master and moments
        self.expect(f"the host plan's device peak is {drop} bytes below the card plan's, at "
                    f"least 0.75 of the fp32 master and moments ({state_bytes})",
                    drop >= 0.75 * state_bytes)
        drills = self.train_drills(init_params)
        seconds["drills"] = time.perf_counter() - t0 - sum(seconds.values())
        print("train path: " + ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items()))
        print(json.dumps({"train_path": {
            "full": full, "graph_check": graph, "host_plan": host, "peak_drop": drop,
            "loss_fell": fell, "cut": cut, "drills": drills, "seconds": seconds,
            "power_limit": self.power_limit}}))

    def mesh_path(self, init_params, dryrun_proc):
        """The mesh layer on the card: (a) one step of each sharding mode on
        a (1, 1) mesh against the unsharded step, (b) the int8 compressed
        all-reduce over the world-1 group against quantize + dequantize,
        (c) a (1, n) mesh with two or more cards, (d) the dry-run's records
        and the traced peak against (a)'s measured one."""
        import itertools

        import torch.distributed as dist

        from repro_torch.data import DataConfig, synthetic_batches
        from repro_torch.launch import step as stp
        from repro_torch.launch.analysis import TraceCounter
        from repro_torch.launch.mesh import make_test_mesh
        from repro_torch.models import transformer as tf
        from repro_torch.models.common import set_sharding_mode
        from repro_torch.optim import adamw
        from repro_torch.runtime import compressed_psum, dequantize_int8, quantize_int8

        torch = self.torch
        t0 = time.perf_counter()
        arch, shape = mesh_cut()
        cfg = arch.model
        print(f"== mesh path: {TRAIN_MODEL} cut to {TRAIN_CUT_LAYERS} layers, full width, "
              f"B={TRAIN_B} S={TRAIN_S}, modes {MESH_MODES} on a (1, 1) mesh over NCCL")
        self.free()
        base = torch.cuda.memory_allocated()
        batch = self.device_batch(next(itertools.islice(
            synthetic_batches(cfg, shape, DataConfig(seed=2)), 1)))
        mesh = make_test_mesh((1, 1), device_type=DEVICE)

        def fresh():
            params = init_params(cfg, torch.Generator(device=DEVICE).manual_seed(3), DEVICE)
            return params, adamw.init_state(params, stp._adamw_cfg(arch, None))

        def timed(fn):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            return out, (time.perf_counter() - t) * 1e3

        out = {"modes": {}, "power_limit": self.power_limit}
        ref_2d = None
        deterministic = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            for mode in MESH_MODES:
                set_sharding_mode(mode)
                try:
                    # (a) the sharded step first, alone on the card, for its peak
                    params, opt = fresh()
                    params, opt = stp.place_train_state(arch, params, opt, mesh)
                    step = stp.build_train_step(arch, shape, mesh)
                    self.free()
                    torch.cuda.reset_peak_memory_stats()
                    (_, opt, m), first_ms = timed(lambda: step(params, opt, batch, TRAIN_CUT_AT))
                    peak = torch.cuda.max_memory_allocated() - base
                    got = {n: p.full_tensor().detach().clone() for n, p in params.named_parameters()}
                    loss = float(m["loss"])
                    _, ms = timed(lambda: step(params, opt, batch, TRAIN_CUT_AT + 1))
                    counter = TraceCounter()
                    with counter:
                        step(params, opt, batch, TRAIN_CUT_AT + 2)
                    torch.cuda.synchronize()
                    del params, opt, step
                    self.free()
                    params, opt = fresh()
                    # the unsharded step run eagerly (the graph step's body),
                    # as the sharded steps run
                    step = stp.build_train_step(arch, shape, None, device=DEVICE).body
                    (_, opt, m2), _ = timed(lambda: step(params, opt, batch, TRAIN_CUT_AT))
                    want = dict(params.named_parameters())
                    loss_ref = float(m2["loss"])
                    worst, bitwise = 0.0, loss == loss_ref
                    for n, w in want.items():
                        err = (got[n].float() - w.detach().float()).abs().max().item()
                        worst = max(worst, err / max(w.detach().float().abs().max().item(), 1e-30))
                        bitwise &= bool(torch.equal(got[n], w.detach()))
                    if mode == "2d":  # (c)'s reference: after this one step
                        ref_2d = ({n: w.detach().cpu().clone() for n, w in want.items()},
                                  loss_ref, float(m2["grad_norm"]))
                    _, plain_ms = timed(lambda: step(params, opt, batch, TRAIN_CUT_AT + 1))
                    del params, opt, step, got, want
                    self.free()
                finally:
                    set_sharding_mode("2d")
                colls = counter.collectives().as_dict()
                rec = {"loss": loss, "loss_unsharded": loss_ref, "bit_for_bit": bitwise,
                       "worst_rel_err": worst, "first_step_ms": first_ms, "step_ms": ms,
                       "unsharded_step_ms": plain_ms, "max_memory_allocated": peak,
                       "collectives": colls}
                out["modes"][mode] = rec
                print(f"mesh {mode}: sharded step {ms:.1f} ms (first {first_ms:.1f} ms), "
                      f"unsharded {plain_ms:.1f} ms, loss {loss!r} vs {loss_ref!r}, worst "
                      f"|diff| / max|param| {worst:.3e}, bit for bit: {bitwise}, peak "
                      f"{peak} bytes, collectives {colls['counts']}")
                self.expect(f"a: {mode} step on the (1, 1) mesh == the unsharded step within "
                            f"{MESH_STEP_TOL:g} of each tensor's largest value",
                            abs(loss - loss_ref) <= MESH_STEP_TOL * abs(loss_ref)
                            and worst <= MESH_STEP_TOL)
        finally:
            torch.use_deterministic_algorithms(deterministic)

        # (b) compressed_psum over the world-1 group on the cut's gradients
        params, _ = fresh()
        names, leaves = zip(*params.named_parameters())
        grads = torch.autograd.grad(tf.loss_fn(params, batch, cfg, remat=arch.train.remat),
                                    leaves)
        same = 0
        for g in grads:
            err = torch.zeros(g.shape, dtype=torch.float32, device=DEVICE)
            for _ in range(2):  # the second round carries the first's error
                mean, new = compressed_psum(g, mesh.get_group("data"), err)
                q, scale = quantize_int8(g.float() + err)
                want = dequantize_int8(q, scale)
                same += bool(torch.equal(mean, want.to(g.dtype))
                             and torch.equal(new, g.float() + err - want))
                err = new
        out["compressed_psum_bit_for_bit"] = f"{same}/{2 * len(grads)}"
        self.expect(f"b: compressed_psum over the world-1 group == dequantize(quantize(g + e)) "
                    f"and its error, bit for bit ({same} of {2 * len(grads)})",
                    same == 2 * len(grads))
        del params, grads, leaves
        dist.destroy_process_group()
        self.free()

        # (c) a (1, n) mesh over NCCL with two or more cards
        n = torch.cuda.device_count()
        if n < 2:
            print(f"mesh (1, n) over NCCL: not run ({n} CUDA device)")
        else:
            self.mesh_cards(n, ref_2d)

        # (d) the dry-run
        try:
            stdout, stderr = dryrun_proc.communicate(timeout=MESH_DRYRUN_TIMEOUT)
        finally:
            if dryrun_proc.poll() is None:
                dryrun_proc.kill()
                dryrun_proc.wait()
        self.expect("d: the dry-run process exits 0", dryrun_proc.returncode == 0)
        if dryrun_proc.returncode != 0:
            print(stderr[-3000:])
            return
        dry = json.loads(stdout.strip().splitlines()[-1])
        cell, roof = dry["cell"], dry["cell"].get("roofline", {})
        mem = cell.get("memory_analysis", {})
        counts = cell.get("collectives_raw", {}).get("counts", {})
        print(f"dry-run starcoder2-3b/train_4k on 16 x 16 (a roofline estimate for 256 H100s, "
              f"not a measurement): {dry['cell_s']:.1f} s, status {cell['status']}, per-device "
              f"{mem.get('argument_gb', 0) + mem.get('peak_extra_gb', 0):.2f} GB, per chip "
              f"{roof.get('hlo_flops_per_chip', 0):.4e} FLOPs, {roof.get('hlo_bytes_per_chip', 0):.4e} "
              f"bytes, {roof.get('collective_bytes_per_chip', 0):.4e} collective bytes; compute_s "
              f"{roof.get('compute_s')}, memory_s {roof.get('memory_s')}, collective_s "
              f"{roof.get('collective_s')}, bound {roof.get('bound')}, mfu_at_roofline "
              f"{roof.get('mfu_at_roofline')}; collectives {counts}")
        for site in cell.get("collectives_raw", {}).get("sites", [])[:6]:
            print(f"d: 16 x 16 link bytes {site['link_bytes']:.4e} from {site['count']} "
                  f"{site['kind']} ({site['op']}) of {site['operand']} at {site['site']}")
        self.expect("d: the 16 x 16 dry-run cell is ok with its roofline",
                    cell["status"] == "ok" and bool(roof))
        self.expect("d: the 16 x 16 train step has an all-reduce or reduce-scatter",
                    counts.get("all-reduce", 0) + counts.get("reduce-scatter", 0) > 0)
        traced = (dry["cut"]["memory"]["argument_gb"] + dry["cut"]["memory"]["peak_extra_gb"]) * GB
        measured = out["modes"]["2d"]["max_memory_allocated"]
        ratio = traced / measured
        print(f"d: the cut's traced peak {traced:.0f} bytes / the 2d step's measured "
              f"max_memory_allocated {measured} = {ratio:.4f} (trace {dry['cut_s']:.1f} s)")
        self.expect(f"d: the traced peak is within {MESH_PEAK_TOL:.0%} of the measured one",
                    abs(ratio - 1) <= MESH_PEAK_TOL)
        bound = self.train_bound(cfg, 0, 4)["bound_flops"]
        flops_ratio = dry["cut"]["flops"] / sum(bound.values())
        print(f"d: the cut's traced FLOPs {dry['cut']['flops']:.4e} / train_bound's analytic "
              f"{sum(bound.values()):.4e} (remat's recompute not counted there) = "
              f"{flops_ratio:.4f}")
        self.expect("d: the traced FLOPs are at least the analytic count", flops_ratio >= 1)
        full = dry["full"]["memory"]
        full_gb = (full["argument_gb"] + full["peak_extra_gb"]) * GB / 1e9
        print(f"d: the full-depth 1 x 1 trace's peak {full_gb:.2f} GB (trace "
              f"{dry['full_s']:.1f} s) beside train_path's measured "
              f"{self.train_full_peak / 1e9:.2f} GB")
        seconds = time.perf_counter() - t0
        print(f"mesh path: {seconds:.1f} s")
        print(json.dumps({"mesh_path": {
            **out, "dryrun": {"cell": {k: cell.get(k) for k in (
                "status", "mesh", "chips", "compile_s", "memory_analysis",
                "cost_analysis_raw", "collectives_raw", "roofline")},
                "cell_s": dry["cell_s"], "cut_memory": dry["cut"]["memory"],
                "cut_flops": dry["cut"]["flops"], "traced_over_measured_peak": ratio,
                "traced_over_analytic_flops": flops_ratio, "full_depth_peak_gb": full_gb,
                "cut_s": dry["cut_s"], "full_s": dry["full_s"]},
            "seconds": seconds}}))

    def mesh_cards(self, n: int, ref_2d):
        """(c): the cut's 2d step on a (1, n) mesh over NCCL against the
        unsharded step, and the compressed mean within one step of the
        plain mean."""
        import tempfile

        import torch.multiprocessing as mp

        torch = self.torch
        with tempfile.TemporaryDirectory() as d:
            ctx = mp.get_context("spawn")
            arch, shape = mesh_cut()
            procs = [ctx.Process(target=mesh_rank, args=(r, n, str(Path(d) / "store"), d,
                                                         arch, shape, DEVICE))
                     for r in range(n)]
            for p in procs:
                p.start()
            for p in procs:
                p.join(MESH_DRYRUN_TIMEOUT)
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
            self.expect(f"c: the {n} ranks exit 0", all(p.exitcode == 0 for p in procs))
            if not all(p.exitcode == 0 for p in procs):
                return
            got = torch.load(Path(d) / "mesh_rank0.pt")
        want, loss_ref, norm_ref = ref_2d
        # sharded products sum in another order: the loss within the bf16
        # gap of the training checks; a parameter may differ where Adam's
        # first step follows a near-zero gradient's sign, by up to 2 lr
        lr = got["lr"]
        off = total = 0
        worst = 0.0
        for k, w in want.items():
            diff = (got["params"][k].float() - w.float()).abs()
            ulp = w.float().abs() * 2.0 ** -7   # at least one bf16 ulp of w
            worst = max(worst, (diff - ulp).max().item())
            off += int((diff > MESH_STEP_TOL * w.float().abs().max()).sum())
            total += diff.numel()
        loss_rel = abs(got["loss"] - loss_ref) / abs(loss_ref)
        # the loss comes before any reduction and Adam's first step hardly
        # sees the gradient's scale: the norm is what shows a reduction
        # that sums where it should average, or reduces twice
        norm_rel = abs(got["grad_norm"] - norm_ref) / abs(norm_ref)
        print(f"mesh (1, {n}): step {got['step_ms']:.1f} ms, collectives "
              f"{got['collectives']['counts']}, loss {got['loss']!r} vs {loss_ref!r} (rel "
              f"{loss_rel:.3e}), grad norm {got['grad_norm']!r} vs {norm_ref!r} (rel "
              f"{norm_rel:.3e}), {off} of {total} parameters off by more than "
              f"{MESH_STEP_TOL:g} of their tensor's largest, each within {worst:.3e} + one bf16 "
              f"ulp (2 lr = {2 * lr:.3e}); compressed mean off the plain mean by "
              f"{got['psum_steps']:.3f} steps")
        self.expect(f"c: the (1, {n}) mesh's loss within {TRAIN_BF16_LOSS_REL:g} of the "
                    f"unsharded step's, parameters within 2 lr + one bf16 ulp, at most 1 % "
                    f"beyond {MESH_STEP_TOL:g}",
                    loss_rel <= TRAIN_BF16_LOSS_REL and worst <= 2 * lr and off <= total // 100)
        self.expect(f"c: the (1, {n}) mesh's gradient norm within {TRAIN_BF16_GRAD_REL:g} of the "
                    f"unsharded step's (the bf16 gradients' limit)", norm_rel <= TRAIN_BF16_GRAD_REL)
        self.expect(f"c: the compressed mean is within one quantisation step of the plain mean",
                    got["psum_steps"] <= 1.0)

    def second_device(self):
        """Each kernel launched on device 1 after device 0: the shared-memory
        limit must be raised on each device, not once per process."""
        torch, k = self.torch, self.kernels
        n = torch.cuda.device_count()
        if n < 2:
            print(f"second-device launches: not run ({n} CUDA device)")
            return
        for dev in ("cuda:0", "cuda:1"):
            def r(*shape, dtype=torch.float32):
                return torch.randn(*shape, device=dev).to(dtype)
            s, x, t = (torch.empty(4096, device=dev).uniform_(lo, hi)
                       for lo, hi in ((5, 30), (1, 100), (0.25, 10)))
            self.check(f"black_scholes on {dev}", k.black_scholes(s, x, t)[0],
                       k.black_scholes(s, x, t, use_kernel=False)[0], 1e-4)
            a, b = r(300, 700), r(700, 250)
            self.check(f"matmul on {dev}", k.matmul(a, b), k.matmul(a, b, use_kernel=False),
                       1e-3 * math.sqrt(700), 1e-2)
            g = r(16, 24, 136)
            coef = torch.tensor([0.5, 0.1, 0.05, 0.02, 0.01], device=dev)
            self.check(f"fdtd3d_step on {dev}", k.fdtd3d_step(g, coef),
                       k.fdtd3d_step(g, coef, use_kernel=False), 1e-4)
            q, kk, v = r(1, 200, 28, 128, dtype=torch.bfloat16), *(
                r(1, 200, 4, 128, dtype=torch.bfloat16) for _ in range(2))
            self.check(f"flash bf16 on {dev}", k.flash_attention(q, kk, v),
                       k.flash_attention(q, kk, v, use_kernel=False), BF16_ATOL, BF16_RTOL)
            kp, vp = (r(10, 32, 8, 128, dtype=torch.bfloat16) for _ in range(2))
            qd = r(2, 64, 128, dtype=torch.bfloat16)
            bt = torch.arange(10, dtype=torch.int32, device=dev)[:8].reshape(2, 4)
            sl = torch.tensor([128, 77], dtype=torch.int32, device=dev)
            self.check(f"paged bf16 on {dev}", k.paged_attention(qd, kp, vp, bt, sl),
                       k.paged_attention(qd, kp, vp, bt, sl, use_kernel=False),
                       BF16_ATOL, BF16_RTOL)

    def kernel_timing_rows(self, kernel_rows):
        print("== kernel timing rows (repro_torch.bench.lm_bench.kernel_rows)")
        for row in kernel_rows(DEVICE):
            print(row)

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
        from repro_torch.bench import run as bench_run
        from repro_torch.bench.lm_bench import arch_step_rows, kernel_rows
        from repro_torch.configs import get_config
        from repro_torch.examples import (kv_serving_demo, oversubscribe_demo, quickstart,
                                          um_advise_tour)
        from repro_torch.examples.oversubscribe_demo import paged_decode
        from repro_torch.models import attention, init_caches, init_params
        from repro_torch.models import transformer as tf
        from repro_torch.umbench import platforms as plat
        from repro_torch.umbench import serving
        from repro_torch.umbench.analysis.__main__ import main as analysis_main
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
    dryrun_proc = start_dryrun()
    try:
        smoke.attention_checks()
        smoke.main_path()
        smoke.paged_path(paged_decode)
        smoke.flash_path(get_config, attention)
        smoke.serve_path(tf, init_params, init_caches)
        smoke.decode_route(tf, init_params)
        smoke.family_serve(tf, init_params, init_caches)
        smoke.model_checks(tf, init_params)
        smoke.movement_path(tf, init_params, tf.Block)
        smoke.um_path(quickstart, um_advise_tour, oversubscribe_demo)
        smoke.sweep_path(serving, plat, analysis_main, kv_serving_demo, bench_run,
                         arch_step_rows)
        smoke.train_path(tf, init_params)
        smoke.mesh_path(init_params, dryrun_proc)
    finally:
        if dryrun_proc.poll() is None:
            dryrun_proc.kill()
            dryrun_proc.wait()
    smoke.second_device()
    smoke.plain_apps()
    smoke.kernel_timing_rows(kernel_rows)
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
