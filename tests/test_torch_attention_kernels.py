"""The port's flash and paged attention wrappers, the paged-decode demo and
the kernel timing rows, against the JAX package on the CPU.

On the CPU the port's wrappers take their plain PyTorch versions; the JAX
wrappers run their Pallas kernels in interpret mode, as tests/test_kernels.py
runs them, and the JAX refs run beside them.  Tolerances are those of
tests/test_kernels.py: fp32 2e-3, bf16 3e-2.  The CUDA kernels are held
against the same plain versions on the card by chip_smoke.py."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # collection must not error (dev-only dependency)
    from _hypothesis_fallback import given, settings, st

from repro import kernels as jk  # noqa: E402
from repro.kernels.flash_attention.ref import flash_attention_ref as jflash_ref  # noqa: E402
from repro.kernels.paged_attention.ref import paged_attention_ref as jpaged_ref  # noqa: E402
from repro_torch import kernels as tk  # noqa: E402
from repro_torch.bench.lm_bench import HEADER, kernel_rows  # noqa: E402
from repro_torch.examples.oversubscribe_demo import TOY, main, paged_decode  # noqa: E402
from repro_torch.interop import to_torch  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402
from repro_torch.kernels.paged_attention.ref import paged_attention_ref  # noqa: E402
from repro_torch.models.attention import attention_flash  # noqa: E402

ATOL = {"float32": 2e-3, "bfloat16": 3e-2}


def _load_chip_smoke():
    """chip_smoke.py, whose full-width limits the tests below hold to."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


smoke = _load_chip_smoke()


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _both(rng, shape, dtype: str = "float32"):
    a = jnp.asarray(rng.standard_normal(shape).astype(np.float32), getattr(jnp, dtype))
    return a, to_torch(np.asarray(a), "cpu")


def _j(t: torch.Tensor):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.view(torch.int16).numpy().view(jnp.bfloat16))
    return jnp.asarray(t.numpy())


# ---------------------------------------------------------------------------
# Flash attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("window", [None, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_jax(hq, hkv, window, dtype):
    rng = np.random.default_rng(hq * 100 + hkv * 10 + (window or 0))
    B, S, Dh = 2, 256, 32
    (qj, qt), (kj, kt), (vj, vt) = (_both(rng, s, dtype) for s in (
        (B, S, hq, Dh), (B, S, hkv, Dh), (B, S, hkv, Dh)))
    mine = tk.flash_attention(qt, kt, vt, window=window)
    assert mine.dtype == qt.dtype and mine.shape == qt.shape
    np.testing.assert_allclose(_f32(mine), _f32(jflash_ref(qj, kj, vj, window=window)),
                               atol=ATOL[dtype])
    # The plain version rounds p to bf16 before the PV product, as the JAX
    # ref does, and the Pallas kernel does not: in bf16 the two also differ
    # by up to 2 ulp of the output (2^-6 relative).
    pallas = jk.flash_attention(qj, kj, vj, window=window, block_q=128, block_kv=128)
    np.testing.assert_allclose(_f32(mine), _f32(pallas), atol=ATOL[dtype],
                               rtol=2.0**-6 if dtype == "bfloat16" else 0)


def test_flash_attention_cross_lengths():
    """Sq < Skv (a continuation chunk): the queries are the last Sq positions."""
    rng = np.random.default_rng(1)
    (qj, qt), (kj, kt), (vj, vt) = (_both(rng, s) for s in (
        (1, 128, 4, 32), (1, 256, 2, 32), (1, 256, 2, 32)))
    mine = tk.flash_attention(qt, kt, vt)
    np.testing.assert_allclose(
        _f32(mine), _f32(jk.flash_attention(qj, kj, vj, block_q=128, block_kv=128)),
        atol=2e-3)
    np.testing.assert_allclose(_f32(mine), _f32(jflash_ref(qj, kj, vj)), atol=2e-3)


@pytest.mark.parametrize("sq,skv,window,causal", [
    (100, 256, None, True), (77, 200, 64, True), (1, 300, None, True),
    (300, 300, None, False)])
def test_flash_attention_ragged_lengths(sq, skv, window, causal):
    """Sq and Skv that no tile divides, against the JAX ref (the Pallas
    kernel asserts divisibility) and the port's blocked online softmax."""
    rng = np.random.default_rng(sq + skv)
    (qj, qt), (kj, kt), (vj, vt) = (_both(rng, s) for s in (
        (2, sq, 4, 16), (2, skv, 2, 16), (2, skv, 2, 16)))
    mine = tk.flash_attention(qt, kt, vt, causal=causal, window=window)
    np.testing.assert_allclose(
        _f32(mine), _f32(jflash_ref(qj, kj, vj, causal=causal, window=window)), atol=2e-3)
    from repro_torch.models.attention import attention_flash
    np.testing.assert_allclose(
        _f32(mine), _f32(attention_flash(qt, kt, vt, causal=causal, window=window,
                                         q_offset=skv - sq, block=64)), atol=2e-3)


# The full-width flash limit of chip_smoke.py: the bf16 kernel rounds P to
# bf16 per KV tile, as the port's attention_flash does in bf16 (and the JAX
# reference); the limit is atol + rtol |want| + row_rtol rms_row(want)
# against attention_flash on the fp32 widening.  It has to pass the
# rounding and reject a one-tile fault.

FULL_S, FULL_H, FULL_DH, FULL_WINDOW = 2048, 2, 128, 512


def _full_width_case():
    rng = np.random.default_rng(13)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, FULL_S, FULL_H, FULL_DH))
                                .astype(np.float32)).to(torch.bfloat16) for _ in range(3))
    return q, k, v, [x.float() for x in (q, k, v)]


def _out_of_limit(got, want) -> tuple[int, float]:
    """(elements out of the limit, largest |got - want| / limit)."""
    limit = smoke.row_scaled_limit(want, smoke.FLASH_FULL_ATOL, smoke.FLASH_FULL_RTOL,
                                   smoke.FLASH_FULL_ROW_RTOL)
    err = (got.float() - want.float()).abs()
    return int((err > limit).sum()), float((err / limit).max())


@pytest.mark.parametrize("window", [None, FULL_WINDOW])
def test_flash_full_width_limit_passes_bf16_p(window):
    q, k, v, wide = _full_width_case()
    want = attention_flash(*wide, window=window, block=smoke.FLASH_CHECK_BLOCK)
    got = attention_flash(q, k, v, window=window, block=64)
    assert got.dtype == torch.bfloat16
    bad, worst = _out_of_limit(got, want)
    assert bad == 0 and worst < 1.0, (bad, worst)
    # the old elementwise limit, written for P in fp32, does not hold
    assert smoke.Smoke.compare(got, want, smoke.FULL_ATOL, smoke.FULL_RTOL)[1] > 0


@pytest.mark.parametrize("window,fault", [
    (None, "diagonal a tile left"), (FULL_WINDOW, "window a tile short"),
    (None, "wrong V tile"), (FULL_WINDOW, "wrong V tile")])
def test_flash_full_width_limit_rejects_one_tile_faults(window, fault):
    _, _, _, wide = _full_width_case()
    kw = dict(window=window, block=smoke.FLASH_CHECK_BLOCK)
    want = attention_flash(*wide, **kw)
    if fault == "diagonal a tile left":
        bad_out = attention_flash(*wide, q_offset=-smoke.FAULT_TILE, **kw)
    elif fault == "window a tile short":
        bad_out = attention_flash(*wide, **{**kw, "window": window - smoke.FAULT_TILE})
    else:
        bad_out = attention_flash(wide[0], wide[1], smoke.wrong_v_tile(wide[2]), **kw)
    bad, _ = _out_of_limit(bad_out, want)
    assert bad > 0
    assert smoke.Smoke.compare(bad_out, want, smoke.FLASH_FULL_ATOL, smoke.FLASH_FULL_RTOL,
                               smoke.FLASH_FULL_ROW_RTOL)[1] == bad


def test_wrong_v_tile_moves_one_tile():
    v = torch.arange(256, dtype=torch.float32).reshape(1, 256, 1, 1)
    bad = smoke.wrong_v_tile(v, tile=64)
    assert bad[0, :128, 0, 0].tolist() == list(range(128))
    assert bad[0, 128:192, 0, 0].tolist() == list(range(64, 128))
    assert bad[0, 192:, 0, 0].tolist() == list(range(192, 256))
    assert v[0, 128, 0, 0] == 128


def test_flash_attention_ref_is_the_offset_dense_path():
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((1, 8, 2, 8), (1, 20, 1, 8), (1, 20, 1, 8)))
    assert torch.equal(tk.flash_attention(q, k, v, use_kernel=False),
                       flash_attention_ref(q, k, v))


# ---------------------------------------------------------------------------
# Paged attention
# ---------------------------------------------------------------------------

def _pool(rng, B, Hq, Hkv, Dh, psz, pages, extra=2, dtype="float32"):
    npages = pages * B + extra
    (kj, kt), (vj, vt) = (_both(rng, (npages, psz, Hkv, Dh), dtype) for _ in range(2))
    qj, qt = _both(rng, (B, Hq, Dh), dtype)
    bt = rng.permutation(npages)[: B * pages].reshape(B, pages).astype(np.int32)
    return (qj, kj, vj, jnp.asarray(bt)), (qt, kt, vt, torch.from_numpy(bt))


@pytest.mark.parametrize("psz,pages", [(16, 4), (32, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_matches_jax(psz, pages, dtype):
    rng = np.random.default_rng(psz * pages)
    jx, tx = _pool(rng, 3, 8, 2, 32, psz, pages, dtype=dtype)
    sl = np.array([psz * pages, psz * pages - 5, 3], np.int32)
    mine = tk.paged_attention(*tx, torch.from_numpy(sl))
    assert mine.dtype == tx[0].dtype and mine.shape == tx[0].shape
    pallas = jk.paged_attention(*jx, jnp.asarray(sl))
    np.testing.assert_allclose(_f32(mine), _f32(pallas), atol=ATOL[dtype])
    np.testing.assert_allclose(_f32(mine), _f32(jpaged_ref(*jx, jnp.asarray(sl))),
                               atol=ATOL[dtype])


@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 2**31 - 1))
def test_paged_attention_block_table_permutation(seed):
    """Permuting the physical pages and the block table with them gives the
    same output."""
    rng = np.random.default_rng(seed)
    B, Hq, Hkv, Dh, psz, pages = 2, 4, 2, 16, 8, 4
    npages = B * pages
    k, v = (torch.from_numpy(rng.standard_normal((npages, psz, Hkv, Dh)).astype(np.float32))
            for _ in range(2))
    q = torch.from_numpy(rng.standard_normal((B, Hq, Dh)).astype(np.float32))
    bt = torch.arange(npages, dtype=torch.int32).reshape(B, pages)
    sl = torch.tensor([psz * pages, psz * pages - 3], dtype=torch.int32)
    out1 = tk.paged_attention(q, k, v, bt, sl)
    perm = torch.from_numpy(rng.permutation(npages))
    inv = torch.argsort(perm).to(torch.int32)
    out2 = tk.paged_attention(q, k[perm], v[perm], inv[bt.long()], sl)
    np.testing.assert_allclose(_f32(out1), _f32(out2), atol=1e-4)


def test_paged_attention_zero_length_gives_zeros():
    rng = np.random.default_rng(4)
    jx, tx = _pool(rng, 3, 8, 2, 32, 16, 4)
    sl = np.array([0, 17, 0], np.int32)
    mine = tk.paged_attention(*tx, torch.from_numpy(sl))
    assert torch.count_nonzero(mine[0]) == 0 and torch.count_nonzero(mine[2]) == 0
    np.testing.assert_allclose(_f32(mine), _f32(jk.paged_attention(*jx, jnp.asarray(sl))),
                               atol=2e-3)


@pytest.mark.parametrize("lens", [(1, 2, 3), (17, 33, 63), (64, 1, 40)])
def test_paged_attention_ragged_lengths(lens):
    """Lengths that end inside a page, against the JAX ref and the port's
    decode attention over the gathered cache."""
    rng = np.random.default_rng(sum(lens))
    jx, tx = _pool(rng, 3, 4, 1, 16, 16, 4)
    sl = np.array(lens, np.int32)
    mine = tk.paged_attention(*tx, torch.from_numpy(sl))
    np.testing.assert_allclose(_f32(mine), _f32(jpaged_ref(*jx, jnp.asarray(sl))),
                               atol=2e-3)
    np.testing.assert_array_equal(
        _f32(mine), _f32(paged_attention_ref(*tx, torch.from_numpy(sl))))


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_decode_matches_jax(dtype):
    res = paged_decode(TOY, dtype=dtype, device="cpu")
    assert res["out"].shape == (2, 8, 64) and res["out"].dtype == dtype
    assert res["k_pool"].shape == (16, 64, 2, 64)
    assert res["block_table"].tolist() == np.arange(16).reshape(2, 8).tolist()
    assert res["seq_lens"].tolist() == [512, 256]
    ref = jk.paged_attention(*(_j(res[k]) for k in (
        "q", "k_pool", "v_pool", "block_table", "seq_lens")))
    np.testing.assert_allclose(_f32(res["out"]), _f32(ref),
                               atol=ATOL[str(dtype).split(".")[-1]])


def test_paged_decode_takes_the_config_geometry():
    res = paged_decode("qwen2-72b", batch=3, pages=2, page_size=8, seed=1,
                       seq_lens=[16, 0, 9], device="cpu")
    assert res["q"].shape == (3, 64, 128) and res["k_pool"].shape == (6, 8, 8, 128)
    assert torch.count_nonzero(res["out"][1]) == 0
    ref = jpaged_ref(*(_j(res[k]) for k in (
        "q", "k_pool", "v_pool", "block_table", "seq_lens")))
    np.testing.assert_allclose(_f32(res["out"]), _f32(ref), atol=2e-3)


def test_demo_main_prints_section_3(capsys):
    """Section 3 after the planner's sections 1-2, which need the device
    memory to plan against on the CPU."""
    main(["--device", "cpu", "--hbm-bytes", "85e9"])
    out = capsys.readouterr().out
    assert "3. Paged decode over a block-table pool" in out
    assert "over 16 pages -> out (2, 8, 64), finite=True" in out
    assert "section 4 waits" in out


def test_kernel_rows_on_the_cpu_skip_the_cuda_variant():
    rows = kernel_rows(device="cpu")
    assert rows[0] == HEADER == "table,kernel,variant,us_per_call,derived"
    body = [r.split(",") for r in rows[1:]]
    assert [(r[1], r[2]) for r in body] == [
        (k, v) for k in ("black_scholes", "streamed_matmul", "flash_attention", "fdtd3d")
        for v in ("cuda", "torch_ref")]
    for r in body:
        if r[2] == "cuda":
            assert r[3] == "" and r[4].startswith("skipped: no CUDA kernel")
        else:
            assert float(r[3]) > 0


@pytest.mark.parametrize("entry", [paged_decode, kernel_rows])
def test_entry_points_default_to_the_card(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is taken")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()


# ---------------------------------------------------------------------------
# Wrapper rules
# ---------------------------------------------------------------------------

def test_cpu_tensors_leave_attention_counters_at_zero():
    tk.flash_attention.launches = tk.paged_attention.launches = 0
    q = torch.randn(1, 8, 2, 16)
    tk.flash_attention(q, q[:, :, :1], q[:, :, :1])
    paged_decode(TOY, batch=2, pages=2, device="cpu")
    assert tk.flash_attention.launches == 0 and tk.paged_attention.launches == 0


def test_attention_wrappers_refuse_other_devices():
    m = torch.empty(1, 8, 2, 16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tk.flash_attention(m, m, m)
    pool = torch.empty(4, 8, 2, 16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tk.paged_attention(torch.empty(2, 4, 16, device="meta"), pool, pool,
                           torch.empty(2, 2, dtype=torch.int32, device="meta"),
                           torch.empty(2, dtype=torch.int32, device="meta"))


def test_attention_wrappers_reject_bad_shapes():
    q = torch.zeros(1, 8, 3, 16)
    with pytest.raises(ValueError):
        tk.flash_attention(q, q[:, :, :2], q[:, :, :2])     # 2 does not divide 3
    with pytest.raises(ValueError):
        tk.flash_attention(q, q, q[:, :4])                  # k and v differ
    with pytest.raises(ValueError, match="window"):
        tk.flash_attention(q, q, q, window=0)
    with pytest.raises(ValueError, match="causal"):
        tk.flash_attention(q, q, q, causal=False, window=4)
    pool = torch.zeros(4, 8, 2, 16)
    bt, sl = torch.zeros(2, 2, dtype=torch.int32), torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        tk.paged_attention(torch.zeros(2, 3, 16), pool, pool, bt, sl)
    with pytest.raises(ValueError):
        tk.paged_attention(torch.zeros(2, 4, 16), pool, pool, bt, sl[:1])
    with pytest.raises(ValueError):
        tk.paged_attention(torch.zeros(2, 4, 8), pool, pool, bt, sl)
