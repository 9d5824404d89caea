"""The decode step's route to the paged decode kernel, on the CPU.

On a card, ``transformer.decode_step`` sends each layer's one-token
attention to ``kernels.paged_attention`` where ``paged_decode_ok`` holds,
reading the layer's cache in place through ``paged_view`` and ``kv_pool``.
The kernel runs only on a card; here its plain version
(``paged_attention_ref``) and the emulation of its algorithm
(``paged_attention_split_ref``, the kernel's chunks and tiles, P as bf16
hi + lo) read the same view, which must give what the plain attention
gives: in fp32 to rounding, in bf16 within the limits of
tests/test_torch_paged_precision.py.  The predicate keeps the plain path
for CPU, fp32, DTensor and other head sizes, and ``decode_step`` with the
route forced on the CPU equals the plain step for every attention family,
ring caches included."""
import dataclasses
import importlib.util
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import spans
from repro_torch.configs import get_config
from repro_torch.kernels.paged_attention.ref import (
    paged_attention_ref, paged_attention_split_ref)
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tf

ROOT = Path(__file__).resolve().parents[1]


def _load_chip_smoke():
    """chip_smoke.py, whose full-width limit the bf16 route is held to."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


smoke = _load_chip_smoke()
BF16_ATOL = 3e-2  # tests/test_torch_paged_precision.py's ATOL["bfloat16"]
F32 = dict(atol=1e-5, rtol=1e-5)


def chunk_pages(psz: int) -> int:
    """Pages of a split-KV work item (csrc/paged_attention.cu, chunk_pages):
    as near 2,048 positions as whole pages allow."""
    return max(1, (2048 + psz // 2) // psz)


def _caches(seed, B, S, hq, hkv, dh, dtype):
    g = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=g).to(dtype)
               for shape in ((B, hq, dh), (B, S, hkv, dh), (B, S, hkv, dh)))
    return q, k, v


def _routed(q, k, v, cache_len):
    """The route's view of the caches through the kernel's plain version
    and its algorithm's emulation."""
    B, S = k.shape[:2]
    psz, table, lens = tf.paged_view(B, S, torch.tensor(cache_len, dtype=torch.int32), "cpu")
    pools = tf.kv_pool(k, psz), tf.kv_pool(v, psz)
    assert pools[0].data_ptr() == k.data_ptr() and pools[1].data_ptr() == v.data_ptr()
    ref = paged_attention_ref(q, *pools, table, lens)
    split = paged_attention_split_ref(q, *pools, table, lens,
                                      pages_per_chunk=chunk_pages(psz))
    return ref, split


def _ring_plain(q, k, v, cache_len):
    """The plain attention of ``_decode_attn``'s ring branch."""
    B, S = k.shape[:2]
    n_valid = cache_len + 1
    valid = (torch.arange(S)[None, :] < n_valid) | (n_valid >= S)
    num, den, m = attn.decode_attention_partial(q, k, v, valid.expand(B, S))
    return attn.combine_decode_partials(num, den, m, None).to(q.dtype)


def _hold(got, want, dtype, want64=None):
    """fp32: to rounding.  bf16: within the JAX tests' bf16 tolerance of
    the plain bf16 attention and, given ``want64``, within chip_smoke.py's
    full-width limit of the fp64 attention, which the kernel's algorithm
    (``paged_attention_split_ref``) meets and the plain bf16 scores and P
    do not."""
    if dtype == torch.float32:
        np.testing.assert_allclose(got.numpy(), want.numpy(), **F32)
        return
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(), atol=BF16_ATOL)
    if want64 is not None:  # chip_smoke.py's full-width limit against fp64
        limit = smoke.FULL_ATOL + smoke.FULL_RTOL * want64.abs()
        assert float(((got.double() - want64).abs() / limit).max()) < 1.0


def _plain64(q, k, v, cache_len, ring=False):
    q, k, v = q.double(), k.double(), v.double()
    if ring:
        return _ring_plain(q, k, v, cache_len)
    return attn.decode_attention(q, k, v, cache_len + 1)


# ---------------------------------------------------------------------------
# the view's arithmetic against the plain attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("at", ["zero", "mid", "last", "full", "past"])
@pytest.mark.parametrize("S", [1280, 2056])
def test_view_equals_plain_qwen2_7b_heads(S, at, dtype):
    """qwen2-7b's heads (Hq 28, Hkv 4, Dh 128) at B 2: the decode cell's
    cache (1,280, pages of 64) and the prefill cell's (2,056, one page a
    sequence), cache_len at 0, mid, S - 1 and past the cache."""
    cache_len = {"zero": 0, "mid": S // 2 + 3, "last": S - 1, "full": S, "past": S + 37}[at]
    q, k, v = _caches(S + cache_len, 2, S, 28, 4, 128, dtype)
    want = attn.decode_attention(q, k, v, cache_len + 1)
    ref, split = _routed(q, k, v, cache_len)
    want64 = _plain64(q, k, v, cache_len) if dtype == torch.bfloat16 else None
    _hold(ref, want, dtype)
    _hold(split, want, dtype, want64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("at", ["mid", "past"])
@pytest.mark.parametrize("S", [4100, 4099])
def test_view_equals_plain_long_unaligned(S, at, dtype):
    """qwen2-7b's heads at B 1 over caches longer than a work item whose
    length 64 does not divide: 4,100 (pages of 1,025, two work items) and
    a prime 4,099 (pages of one position)."""
    cache_len = {"mid": S // 2 + 3, "past": S + 37}[at]
    q, k, v = _caches(S + cache_len, 1, S, 28, 4, 128, dtype)
    want = attn.decode_attention(q, k, v, cache_len + 1)
    ref, split = _routed(q, k, v, cache_len)
    want64 = _plain64(q, k, v, cache_len) if dtype == torch.bfloat16 else None
    _hold(ref, want, dtype)
    _hold(split, want, dtype, want64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("cache_len", [10, 63, 64, 100, 200])
def test_view_equals_plain_ring(cache_len, dtype):
    """A ring cache of window 64 (mixtral's reduced window), before, at and
    past its wrap: the kernel's first min(cache_len + 1, S) slots are the
    ring branch's valid ones."""
    q, k, v = _caches(cache_len, 2, 64, 8, 2, 64, dtype)
    want = _ring_plain(q, k, v, cache_len)
    ref, split = _routed(q, k, v, cache_len)
    want64 = _plain64(q, k, v, cache_len, ring=True) if dtype == torch.bfloat16 else None
    _hold(ref, want, dtype)
    _hold(split, want, dtype, want64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("hq,hkv,dh", [(4, 4, 64), (24, 2, 128)], ids=["G1", "G12"])
@pytest.mark.parametrize("cache_len", [5, 700])
def test_view_equals_plain_groups(hq, hkv, dh, cache_len, dtype):
    """G 1 (musicgen's heads) and G 12 (starcoder2-3b's, the kernel's
    two-tile instance) at S 1,280."""
    q, k, v = _caches(hq + cache_len, 2, 1280, hq, hkv, dh, dtype)
    want = attn.decode_attention(q, k, v, cache_len + 1)
    ref, split = _routed(q, k, v, cache_len)
    want64 = _plain64(q, k, v, cache_len) if dtype == torch.bfloat16 else None
    _hold(ref, want, dtype)
    _hold(split, want, dtype, want64)


@pytest.mark.parametrize("S,psz,pages", [(1280, 64, 20), (2056, 2056, 1), (64, 64, 1),
                                         (2080, 2080, 1), (32769, 993, 33), (32776, 1928, 17),
                                         (2053, 2053, 1), (4099, 1, 4099)])
def test_view_shapes(S, psz, pages):
    """Pages of 64 where 64 divides S, else those of ``page_size``; the
    identity block table; seq_lens cache_len + 1 from an int or a 0-d
    tensor alike, int32."""
    for n in (7, torch.tensor(7, dtype=torch.int32), torch.tensor(7)):
        got_psz, table, lens = tf.paged_view(3, S, n, "cpu")
        assert got_psz == psz
        assert table.dtype == lens.dtype == torch.int32
        assert table.is_contiguous() and lens.is_contiguous()
        assert torch.equal(table, torch.arange(3 * pages, dtype=torch.int32).view(3, pages))
        assert torch.equal(lens, torch.full((3,), 8, dtype=torch.int32))
    cache = torch.zeros(3, S, 4, 16)
    assert tf.kv_pool(cache, psz).shape == (3 * S // psz, psz, 4, 16)


@pytest.mark.parametrize("S", [63, 100, 1056, 2053, 2056, 2080, 3072, 3080, 4100, 16385,
                               32769, 32776, 65537, 1 << 17])
def test_page_size_splits_long_caches(S):
    """The page divides S and is at most a work item of 2,048 positions (S
    itself up to 3,072); of those it has the largest TMA box, gcd(page, 64)
    rows or none where the page is no multiple of 8, and is the longest
    with it; and a long cache keeps as many of the kernel's work items as
    pages of 64 would, or more."""
    def box(d):
        return math.gcd(d, tf.PAGE) if d % 8 == 0 else 0

    psz = tf.page_size(S)
    if S % tf.PAGE == 0:
        assert psz == tf.PAGE
        return
    fits = [d for d in range(1, S + 1)
            if S % d == 0 and (d <= tf.CHUNK or d == S <= 3 * tf.CHUNK // 2)]
    assert psz in fits
    assert box(psz) == max(map(box, fits))
    assert psz == max(d for d in fits if box(d) == box(psz))
    per_item = chunk_pages(psz) * psz
    assert -(-S // per_item) >= S // (2 * tf.CHUNK)


# ---------------------------------------------------------------------------
# the route's predicate
# ---------------------------------------------------------------------------

def _fake(shape, dtype, device="cuda"):
    with FakeTensorMode():
        return torch.empty(shape, dtype=dtype, device=device)


@pytest.mark.parametrize("case,want", [
    ("cuda_bf16", True), ("cuda_bf16_stacked", True), ("cpu_bf16", False),
    ("cuda_fp32", False), ("cuda_dh96", False), ("cuda_group32", False)])
def test_predicate(case, want):
    """The kernel route for a bf16 cache described on a card at qwen2-7b's
    heads (one layer's or the stacked caches); the plain path for a CPU,
    fp32 or Dh 96 cache, or more than MAX_GROUP query heads a KV head."""
    cache, heads = {
        "cuda_bf16": (_fake((16, 1280, 4, 128), torch.bfloat16), 28),
        "cuda_bf16_stacked": (_fake((28, 16, 1280, 4, 128), torch.bfloat16), 28),
        "cpu_bf16": (torch.empty(16, 1280, 4, 128, dtype=torch.bfloat16), 28),
        "cuda_fp32": (_fake((16, 1280, 4, 128), torch.float32), 28),
        "cuda_dh96": (_fake((16, 1280, 4, 96), torch.bfloat16), 28),
        "cuda_group32": (_fake((16, 1280, 2, 128), torch.bfloat16), 64),
    }[case]
    assert tf.paged_decode_ok(cache, heads) is want


DTENSOR_SCRIPT = r"""
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Replicate
from repro_torch.launch.mesh import fake_process_group, make_test_mesh
from repro_torch.models import transformer as tf

fake_process_group(1)
mesh = make_test_mesh((1, 1), device_type="cpu")
with FakeTensorMode():
    local = torch.empty(16, 1280, 4, 128, dtype=torch.bfloat16, device="cuda")
assert tf.paged_decode_ok(local, 28)
cache = DTensor.from_local(local, mesh, [Replicate(), Replicate()], run_check=False)
assert isinstance(cache, DTensor)
print("dtensor", tf.paged_decode_ok(cache, 28))
"""


def test_predicate_dtensor():
    """A mesh's cache, a DTensor over a bf16 card tensor the kernel would
    take alone, keeps the plain path (a fake-backend process group, in a
    subprocess: a process group is global)."""
    out = subprocess.run([sys.executable, "-c", DTENSOR_SCRIPT], capture_output=True,
                         text=True, timeout=300, cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "dtensor False"


# ---------------------------------------------------------------------------
# decode_step: counters, and the route forced on the CPU
# ---------------------------------------------------------------------------

def _model(arch, dtype="float32"):
    cfg = dataclasses.replace(get_config(arch).model.reduce(), dtype=dtype)
    params = tf.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    return cfg, params


def _filled_caches(cfg, B, S, seed):
    caches = tf.init_caches(cfg, B, S, "cpu")
    g = torch.Generator().manual_seed(seed)
    for name in ("k", "v"):
        caches[name].copy_(torch.randn(caches[name].shape, generator=g))
    return caches


def _tokens(cfg, B, seed):
    g = torch.Generator().manual_seed(seed)
    shape = (B, cfg.num_codebooks) if cfg.family == "audio" else (B,)
    return {"tokens": torch.randint(0, cfg.vocab_size, shape, generator=g)}


def test_decode_step_on_cpu_counts_plain():
    """On the CPU every layer takes the plain attention, bf16 or not, and
    counts it on the innermost open span; the kernel route is never
    counted."""
    cfg, params = _model("qwen2-7b", "bfloat16")
    caches = _filled_caches(cfg, 2, 32, 0)
    with spans.recording() as rec, spans.span("step"):
        tf.decode_step(params, _tokens(cfg, 2, 0), caches,
                       torch.tensor(5, dtype=torch.int32), cfg)
    (step,) = rec.named("step")
    assert step.counts == {"attn.decode_plain": cfg.num_layers}


@pytest.mark.parametrize("arch", ["qwen2-7b", "mixtral-8x22b", "hymba-1.5b",
                                  "musicgen-medium", "starcoder2-3b"])
def test_decode_step_route_forced_equals_plain(arch, monkeypatch):
    """``decode_step`` with the predicate forced true on the CPU (the view
    built once a step, each layer's pools through ``kv_pool``, the kernel's
    plain version) against the plain step on copies of the same caches:
    the same logits and caches over steps that cross a ring cache's wrap
    (mixtral and hymba reduced: window 64, a 64-slot ring) and a plain
    cache's end, with cache_len a 0-d tensor and an int; one
    ``attn.decode_kernel`` count a layer a step."""
    cfg, params = _model(arch)
    B, S = 2, 64
    plain = _filled_caches(cfg, B, S, 1)
    routed = {k: v.clone() for k, v in plain.items()}
    for step, n in enumerate((3, 62, 63, 64, 90)):
        batch = _tokens(cfg, B, step)
        cache_len = torch.tensor(n, dtype=torch.int32) if step % 2 else n
        want, _ = tf.decode_step(params, batch, plain, cache_len, cfg)
        with monkeypatch.context() as m:
            m.setattr(tf, "paged_decode_ok", lambda cache, heads: True)
            with spans.recording() as rec, spans.span("step"):
                got, _ = tf.decode_step(params, batch, routed, cache_len, cfg)
        assert rec.named("step")[0].counts == {"attn.decode_kernel": cfg.num_layers}
        np.testing.assert_allclose(got.numpy(), want.numpy(), **F32)
        for name in plain:
            np.testing.assert_allclose(routed[name].numpy(), plain[name].numpy(), **F32)
