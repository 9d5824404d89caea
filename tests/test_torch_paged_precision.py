"""The numerical argument behind the port's bf16 paged decode kernel
(``csrc/paged_attention.cu``), emulated in plain PyTorch on the CPU by
``paged_attention_split_ref``: stages of 64 positions split among four
warps, each with its own online softmax in fp32; P V with P as two bf16
parts, hi = bf16(P) and lo = bf16(P - hi), each product exact and summed
in fp32; the warps' partials merged in warp order and the split-KV chunks'
in chunk order.

The emulation must agree with the JAX reference and the Pallas kernel at
the JAX tests' tolerances, stay within the full-width limit of
``chip_smoke.py`` (FULL_ATOL + FULL_RTOL |want|) against fp64 at every
length, where a single bf16 P fails it on short rows, and give the same
result for any chunk size, with no NaN from chunks or rows past seq_len."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import kernels as jk  # noqa: E402
from repro.kernels.paged_attention.ref import paged_attention_ref as jpaged_ref  # noqa: E402
from repro_torch.interop import to_torch  # noqa: E402
from repro_torch.kernels.paged_attention.ref import (  # noqa: E402
    paged_attention_ref, paged_attention_split_ref)


def _load_chip_smoke():
    """chip_smoke.py, whose full-width limit the tests below hold to."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


smoke = _load_chip_smoke()
ATOL = {"float32": 2e-3, "bfloat16": 3e-2}
# the kernel's chunk at a page size of 64: about 2,048 positions
# (csrc/paged_attention.cu, kChunkPositions)
DEMO_CHUNK_PAGES = 32


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _both(rng, shape, dtype):
    a = jnp.asarray(rng.standard_normal(shape).astype(np.float32), getattr(jnp, dtype))
    return a, to_torch(np.asarray(a), "cpu")


def _pool(rng, B, Hq, Hkv, Dh, psz, pages, dtype="float32", extra=2):
    """Seeded pools with a permuted block table, as JAX and torch arrays."""
    npages = pages * B + extra
    (kj, kt), (vj, vt) = (_both(rng, (npages, psz, Hkv, Dh), dtype) for _ in range(2))
    qj, qt = _both(rng, (B, Hq, Dh), dtype)
    bt = rng.permutation(npages)[: B * pages].reshape(B, pages).astype(np.int32)
    return (qj, kj, vj, jnp.asarray(bt)), (qt, kt, vt, torch.from_numpy(bt))


# ---------------------------------------------------------------------------
# (a) the emulation against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("psz,pages,lens", [
    (16, 4, (64, 59, 3)), (32, 8, (256, 251, 3)), (16, 4, (1, 2, 3)),
    (16, 4, (17, 33, 63)), (16, 4, (64, 1, 40)), (16, 4, (0, 17, 0))],
    ids=["full", "full_psz32", "ragged_short", "ragged_mid", "ragged_mixed", "zero_length"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_split_ref_matches_jax(psz, pages, lens, dtype):
    rng = np.random.default_rng(psz * pages + sum(lens))
    jx, tx = _pool(rng, 3, 8, 2, 32, psz, pages, dtype=dtype)
    sl = np.array(lens, np.int32)
    mine = paged_attention_split_ref(*tx, torch.from_numpy(sl), pages_per_chunk=3)
    assert mine.dtype == tx[0].dtype and mine.shape == tx[0].shape
    np.testing.assert_allclose(_f32(mine), _f32(jpaged_ref(*jx, jnp.asarray(sl))),
                               atol=ATOL[dtype])
    np.testing.assert_allclose(_f32(mine), _f32(jk.paged_attention(*jx, jnp.asarray(sl))),
                               atol=ATOL[dtype])
    for b, n in enumerate(lens):
        if n == 0:
            assert torch.count_nonzero(mine[b]) == 0


@pytest.mark.parametrize("pages_per_chunk", [1, 3])
def test_split_ref_block_table_permutation(pages_per_chunk):
    """Permuting the physical pages and the block table with them gives the
    same output, chunk by chunk."""
    rng = np.random.default_rng(pages_per_chunk)
    B, Hq, Hkv, Dh, psz, pages = 2, 4, 2, 16, 8, 4
    npages = B * pages
    k, v = (torch.from_numpy(rng.standard_normal((npages, psz, Hkv, Dh)).astype(np.float32))
            for _ in range(2))
    q = torch.from_numpy(rng.standard_normal((B, Hq, Dh)).astype(np.float32))
    bt = torch.arange(npages, dtype=torch.int32).reshape(B, pages)
    sl = torch.tensor([psz * pages, psz * pages - 3], dtype=torch.int32)
    out1 = paged_attention_split_ref(q, k, v, bt, sl, pages_per_chunk=pages_per_chunk)
    perm = torch.from_numpy(rng.permutation(npages))
    inv = torch.argsort(perm).to(torch.int32)
    out2 = paged_attention_split_ref(q, k[perm], v[perm], inv[bt.long()], sl,
                                     pages_per_chunk=pages_per_chunk)
    np.testing.assert_allclose(_f32(out1), _f32(out2), atol=1e-6)
    np.testing.assert_allclose(_f32(out1), _f32(paged_attention_ref(q, k, v, bt, sl)),
                               atol=2e-3)


def test_split_ref_wraps_and_clamps_page_ids():
    """A negative id wraps once and an id past the pool is clamped, as the
    kernel and the JAX gather index."""
    rng = np.random.default_rng(5)
    _, (q, k, v, bt) = _pool(rng, 2, 4, 2, 16, 8, 3)
    npages = k.shape[0]
    odd = bt.clone()
    odd[0, 0], odd[1, 2] = bt[0, 0] - npages, npages + 7
    fixed = bt.clone()
    fixed[1, 2] = npages - 1
    sl = torch.tensor([24, 24], dtype=torch.int32)
    np.testing.assert_array_equal(
        _f32(paged_attention_split_ref(q, k, v, odd, sl, pages_per_chunk=2)),
        _f32(paged_attention_split_ref(q, k, v, fixed, sl, pages_per_chunk=2)))


# ---------------------------------------------------------------------------
# (b) P as bf16 hi + lo against fp64, at chip_smoke.py's full-width limit
# ---------------------------------------------------------------------------

def _long_rows(length, B=4, Hkv=1, G=8, Dh=128, psz=64):
    """bf16 inputs of B rows of ``length`` positions at qwen2-72b's head
    geometry (Dh 128, G 8), and the fp64 plain version of the same values."""
    rng = np.random.default_rng(length)
    pages = -(-length // psz)
    npages = B * pages
    k, v = (torch.from_numpy(rng.standard_normal((npages, psz, Hkv, Dh)).astype(np.float32))
            .to(torch.bfloat16) for _ in range(2))
    q = torch.from_numpy(rng.standard_normal((B, Hkv * G, Dh)).astype(np.float32)
                         ).to(torch.bfloat16)
    bt = torch.from_numpy(rng.permutation(npages).reshape(B, pages).astype(np.int32))
    sl = torch.full((B,), length, dtype=torch.int32)
    want = paged_attention_ref(q.double(), k.double(), v.double(), bt, sl)
    return (q, k, v, bt, sl), want


def _worst(got, want) -> float:
    """Largest |got - want| / (FULL_ATOL + FULL_RTOL |want|)."""
    limit = smoke.FULL_ATOL + smoke.FULL_RTOL * want.abs()
    return float(((got.double() - want).abs() / limit).max())


@pytest.mark.parametrize("length", [64, 640, 4096])
def test_hi_lo_p_meets_the_full_width_limit(length):
    inputs, want = _long_rows(length)
    got = paged_attention_split_ref(*inputs, pages_per_chunk=DEMO_CHUNK_PAGES)
    assert got.dtype == torch.bfloat16
    assert _worst(got, want) < 1.0


@pytest.mark.parametrize("length", [64, 640])
def test_one_bf16_p_fails_the_full_width_limit_on_short_rows(length):
    inputs, want = _long_rows(length)
    assert _worst(paged_attention_split_ref(*inputs, pages_per_chunk=DEMO_CHUNK_PAGES,
                                            p_parts=1), want) > 1.0


def _short_rows(case, seed):
    """bf16 inputs of chip_smoke.PAGED_SHORT_CASES' shape with its lengths,
    and the fp64 plain version of the same values."""
    psz, pages, hq, hkv, dh = case
    rng = np.random.default_rng(seed)
    B = len(smoke.PAGED_SHORT_LENS)
    _, (q, k, v, bt) = _pool(rng, B, hq, hkv, dh, psz, pages, dtype="bfloat16")
    sl = torch.tensor(smoke.PAGED_SHORT_LENS, dtype=torch.int32)
    want = paged_attention_ref(q.double(), k.double(), v.double(), bt, sl)
    return (q, k, v, bt, sl), want


@pytest.mark.parametrize("case", smoke.PAGED_SHORT_CASES, ids=str)
def test_hi_lo_p_meets_the_limit_in_every_instance(case):
    """chip_smoke.py's short rows at the test shapes, which reach every
    template instance of the kernel, stay within the full-width limit."""
    inputs, want = _short_rows(case, sum(case))
    got = paged_attention_split_ref(*inputs, pages_per_chunk=3)
    assert _worst(got, want) < 1.0


@pytest.mark.parametrize("case", smoke.PAGED_SHORT_CASES, ids=str)
def test_one_bf16_p_fails_the_limit_in_every_instance(case):
    """... and a single bf16 P fails it there, so chip_smoke.py's check of
    those shapes would catch a kernel instance that dropped P's lo part."""
    inputs, want = _short_rows(case, sum(case))
    assert _worst(paged_attention_split_ref(*inputs, pages_per_chunk=3, p_parts=1),
                  want) > 1.0


# ---------------------------------------------------------------------------
# (c) the split-KV merge
# ---------------------------------------------------------------------------

def _chunk_case(poison_past_len=False):
    """fp32 pools, 4 rows of up to 16 pages of 16; lengths that end inside
    a page, on a chunk edge and at 0.  With ``poison_past_len`` every
    position at or past a row's length holds NaN."""
    rng = np.random.default_rng(11)
    B, Hq, Hkv, Dh, psz, pages = 4, 8, 2, 32, 16, 16
    _, (q, k, v, bt) = _pool(rng, B, Hq, Hkv, Dh, psz, pages)
    sl = torch.tensor([psz * pages, 7 * psz, 3 * psz + 5, 0], dtype=torch.int32)
    if poison_past_len:
        k, v = k.clone(), v.clone()
        for b in range(B):
            for j in range(pages):
                first = max(int(sl[b]) - j * psz, 0)
                k[bt[b, j], first:] = float("nan")
                v[bt[b, j], first:] = float("nan")
    return q, k, v, bt, sl


def test_chunk_sizes_agree():
    q, k, v, bt, sl = _chunk_case()
    outs = [paged_attention_split_ref(q, k, v, bt, sl, pages_per_chunk=n)
            for n in (1, 2, 7, bt.shape[1])]
    for out in outs[1:]:
        np.testing.assert_allclose(_f32(out), _f32(outs[0]), atol=1e-6, rtol=0)
    np.testing.assert_allclose(_f32(outs[0]), _f32(paged_attention_ref(q, k, v, bt, sl)),
                               atol=2e-3)


@pytest.mark.parametrize("pages_per_chunk", [1, 2, 7])
def test_chunks_past_seq_len_leave_no_nan(pages_per_chunk):
    clean = _chunk_case()
    q, k, v, bt, sl = _chunk_case(poison_past_len=True)
    out = paged_attention_split_ref(q, k, v, bt, sl, pages_per_chunk=pages_per_chunk)
    assert torch.isfinite(out).all()
    assert torch.count_nonzero(out[3]) == 0
    np.testing.assert_array_equal(
        _f32(out), _f32(paged_attention_split_ref(*clean, pages_per_chunk=pages_per_chunk)))
