"""The port's attention module (``repro_torch.models.attention``) and its
copied configs against the JAX package, on the same numpy-seeded inputs.
fp32 is held at the JAX attention tests' 1e-5 (tests/test_attention_and_data.py),
bf16 at the JAX kernel tests' 3e-2 (tests/test_kernels.py): in bf16 both
frameworks round the score and PV products to bf16, at other places."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import attention as ja  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.interop import to_torch  # noqa: E402
from repro_torch.models import attention as ta  # noqa: E402

DTYPES = {"float32": (np.float32, jnp.float32, 1e-5),
          "bfloat16": (np.float32, jnp.bfloat16, 3e-2)}


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _both(rng, shape, dtype: str):
    """The same N(0, 1) draw as a JAX array and a torch tensor of ``dtype``."""
    a = jnp.asarray(rng.standard_normal(shape).astype(np.float32), DTYPES[dtype][1])
    return a, to_torch(np.asarray(a), "cpu")


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", jconfigs.ARCH_NAMES)
def test_config_copy_matches_jax(name):
    """``get_config`` returns the whole ``ArchConfig`` (model, train and UM
    policy), equal to the reference's, and ``.model.reduce()`` works."""
    mine, ref = tconfigs.get_config(name), jconfigs.get_config(name)
    assert type(mine).__name__ == "ArchConfig"
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert mine.name == ref.name
    m, r = mine.model, ref.model
    assert (m.num_heads, m.num_kv_heads, m.head_dim, m.sliding_window,
            m.dtype) == (r.num_heads, r.num_kv_heads, r.head_dim,
                         r.sliding_window, r.dtype)
    assert dataclasses.asdict(m.reduce()) == dataclasses.asdict(r.reduce())
    assert m.padded_vocab == r.padded_vocab
    assert m.total_params() == r.total_params()
    assert m.active_params() == r.active_params()
    for shape in jconfigs.SHAPES.values():
        assert mine.supports_shape(tconfigs.get_shape(shape.name)) == \
            ref.supports_shape(shape)


def test_attention_geometry_of_the_served_configs():
    assert tconfigs.ARCH_NAMES == jconfigs.ARCH_NAMES
    geo = {n: (c.num_heads, c.num_kv_heads, c.head_dim, c.sliding_window)
           for n in tconfigs.ARCH_NAMES for c in [tconfigs.get_config(n).model]}
    assert geo == {"starcoder2-3b": (24, 2, 128, None),
                   "nemotron-4-15b": (48, 8, 128, None),
                   "qwen2-7b": (28, 4, 128, None), "qwen2-72b": (64, 8, 128, None),
                   "rwkv6-3b": (0, 0, 0, None), "hymba-1.5b": (25, 5, 64, 1024),
                   "grok-1-314b": (48, 8, 128, None),
                   "mixtral-8x22b": (48, 8, 128, 4096),
                   "musicgen-medium": (24, 24, 64, None),
                   "qwen2-vl-2b": (12, 2, 128, None)}


def test_shapes_match_jax():
    assert set(tconfigs.SHAPES) == set(jconfigs.SHAPES)
    for name, shape in tconfigs.SHAPES.items():
        assert dataclasses.asdict(shape) == dataclasses.asdict(jconfigs.get_shape(name))
        assert shape.tokens == jconfigs.get_shape(name).tokens


def test_unknown_config_raises():
    with pytest.raises(KeyError, match="unknown arch"):
        tconfigs.get_config("gpt-2")


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("groups", [1, 2, 4])
def test_repeat_kv_matches_jax(groups):
    kj, kt = _both(np.random.default_rng(groups), (2, 5, 3, 4), "float32")
    np.testing.assert_array_equal(_f32(ta.repeat_kv(kt, groups)),
                                  _f32(ja.repeat_kv(kj, groups)))


@pytest.mark.parametrize("window", [None, 1, 5])
@pytest.mark.parametrize("q_offset", [0, 3])
def test_causal_mask_matches_jax(window, q_offset):
    mine = ta.causal_mask(7, 11, window=window, q_offset=q_offset)
    np.testing.assert_array_equal(mine.numpy(), np.asarray(
        ja.causal_mask(7, 11, window=window, q_offset=q_offset)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 24), (False, None)])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (6, 2)])
def test_attention_matches_jax(dtype, causal, window, hq, hkv):
    rng = np.random.default_rng(hq * 10 + hkv)
    B, Sq, Skv, Dh = 2, 40, 64, 16
    (qj, qt), (kj, kt), (vj, vt) = (_both(rng, s, dtype) for s in (
        (B, Sq, hq, Dh), (B, Skv, hkv, Dh), (B, Skv, hkv, Dh)))
    mine = ta.attention(qt, kt, vt, causal=causal, window=window, q_offset=Skv - Sq)
    ref = ja.attention(qj, kj, vj, causal=causal, window=window, q_offset=Skv - Sq)
    assert mine.dtype == qt.dtype and mine.shape == (B, Sq, hq, Dh)
    np.testing.assert_allclose(_f32(mine), _f32(ref), atol=DTYPES[dtype][2])


def test_attention_takes_a_mask_and_a_scale():
    rng = np.random.default_rng(7)
    (qj, qt), (kj, kt), (vj, vt) = (_both(rng, (1, 16, 2, 8), "float32")
                                    for _ in range(3))
    mask = rng.random((1, 1, 1, 16, 16)) < 0.7
    mask[..., 0] = True
    mine = ta.attention(qt, kt, vt, causal=False, mask=torch.from_numpy(mask),
                        softmax_scale=0.5)
    ref = ja.attention(qj, kj, vj, causal=False, mask=jnp.asarray(mask),
                       softmax_scale=0.5)
    np.testing.assert_allclose(_f32(mine), _f32(ref), atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 20, 64])
@pytest.mark.parametrize("sq,skv,block", [(96, 96, 32), (40, 100, 32), (64, 64, 1024)])
def test_attention_flash_matches_jax(dtype, window, sq, skv, block):
    """Sq < Skv, a window, and a last KV block that is ragged (100 = 3 x 32 + 4)."""
    rng = np.random.default_rng(sq + skv + block)
    (qj, qt), (kj, kt), (vj, vt) = (_both(rng, s, dtype) for s in (
        (2, sq, 4, 16), (2, skv, 2, 16), (2, skv, 2, 16)))
    kw = dict(causal=True, window=window, q_offset=skv - sq, block=block)
    mine = ta.attention_flash(qt, kt, vt, **kw)
    np.testing.assert_allclose(_f32(mine), _f32(ja.attention_flash(qj, kj, vj, **kw)),
                               atol=DTYPES[dtype][2])
    dense = ta.attention(qt, kt, vt, causal=True, window=window, q_offset=skv - sq)
    np.testing.assert_allclose(_f32(mine), _f32(dense), atol=DTYPES[dtype][2])


def test_attention_flash_without_causal_mask():
    rng = np.random.default_rng(3)
    (qj, qt), (kj, kt), (vj, vt) = (_both(rng, s, "float32") for s in (
        (1, 24, 2, 8), (1, 50, 1, 8), (1, 50, 1, 8)))
    mine = ta.attention_flash(qt, kt, vt, causal=False, block=16)
    ref = ja.attention_flash(qj, kj, vj, causal=False, block=16)
    np.testing.assert_allclose(_f32(mine), _f32(ref), atol=1e-5)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_attention_partial_matches_jax(dtype):
    rng = np.random.default_rng(11)
    B, S, Hq, Hkv, Dh = 2, 48, 8, 2, 16
    (qj, qt), (kj, kt), (vj, vt) = (_both(rng, s, dtype) for s in (
        (B, Hq, Dh), (B, S, Hkv, Dh), (B, S, Hkv, Dh)))
    valid = rng.random((B, S)) < 0.6
    mine = ta.decode_attention_partial(qt, kt, vt, torch.from_numpy(valid))
    ref = ja.decode_attention_partial(qj, kj, vj, jnp.asarray(valid))
    tol = DTYPES[dtype][2]
    for got, want in zip(mine, ref):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)
    np.testing.assert_allclose(
        _f32(ta.combine_decode_partials(*mine, None)),
        _f32(ja.combine_decode_partials(*ref, None)), atol=tol)


def test_split_kv_partials_combine_to_the_whole():
    """Four shards' partials, merged with the running-max rule, equal the
    whole cache's combine (the JAX test of the same name, on the port)."""
    rng = np.random.default_rng(5)
    q = torch.from_numpy(rng.standard_normal((2, 4, 16)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 64, 2, 16)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 64, 2, 16)).astype(np.float32))
    valid = torch.ones(2, 64, dtype=torch.bool)
    full = ta.combine_decode_partials(*ta.decode_attention_partial(q, k, v, valid), None)
    chunks = [ta.decode_attention_partial(q, k[:, i::4], v[:, i::4], valid[:, i::4])
              for i in range(4)]
    g_m = torch.stack([c[2] for c in chunks]).amax(0)
    num = sum(c[0] * torch.exp(c[2] - g_m)[..., None] for c in chunks)
    den = sum(c[1] * torch.exp(c[2] - g_m) for c in chunks)
    np.testing.assert_allclose(_f32(num / den[..., None].clamp_min(1e-20)),
                               _f32(full), atol=1e-5)


def test_combine_over_a_mesh_axis_waits():
    """A combine over a mesh axis needs the mesh it names: with no mesh
    context it raises (tests/test_torch_compression.py holds the combine
    over a gloo mesh against JAX's under vmap)."""
    z = torch.zeros(1, 2, 4)
    with pytest.raises(ValueError, match="mesh context"):
        ta.combine_decode_partials(z, z[..., 0], z[..., 0], "model")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cache_len,window,seq_offset", [
    (10, None, 0), (32, None, 0), (20, 8, 0), (40, None, 16), (1, None, 0)])
def test_decode_attention_matches_jax(dtype, cache_len, window, seq_offset):
    rng = np.random.default_rng(cache_len)
    B, S, Hq, Hkv, Dh = 2, 32, 4, 1, 8
    (qj, qt), (kj, kt), (vj, vt) = (_both(rng, s, dtype) for s in (
        (B, Hq, Dh), (B, S, Hkv, Dh), (B, S, Hkv, Dh)))
    mine = ta.decode_attention(qt, kt, vt, cache_len, window=window,
                               seq_offset=seq_offset)
    ref = ja.decode_attention(qj, kj, vj, jnp.int32(cache_len), window=window,
                              seq_offset=seq_offset)
    assert mine.dtype == qt.dtype
    np.testing.assert_allclose(_f32(mine), _f32(ref), atol=DTYPES[dtype][2])


def test_decode_attention_masks_beyond_cache_len():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 2, 8)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 32, 1, 8)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((1, 32, 1, 8)).astype(np.float32))
    short = ta.decode_attention(q, k, v, 10)
    k2, v2 = k.clone(), v.clone()
    k2[:, 10:] = 99.0
    v2[:, 10:] = -99.0
    np.testing.assert_allclose(_f32(ta.decode_attention(q, k2, v2, 10)),
                               _f32(short), atol=1e-6)


@pytest.mark.parametrize("new_ndim", [3, 4])
@pytest.mark.parametrize("cache_len", [0, 5, 15, 20])
def test_update_kv_cache_matches_jax(new_ndim, cache_len):
    """Insert at cache_len, cast to the cache's dtype, clamp past the end
    as lax.dynamic_update_slice does, and leave the given caches alone."""
    rng = np.random.default_rng(cache_len + new_ndim)
    B, S, Hkv, Dh = 2, 16, 2, 4
    (kcj, kct), (vcj, vct) = (_both(rng, (B, S, Hkv, Dh), "bfloat16") for _ in range(2))
    shape = (B, Hkv, Dh) if new_ndim == 3 else (B, 1, Hkv, Dh)
    (knj, knt), (vnj, vnt) = (_both(rng, shape, "float32") for _ in range(2))
    before = kct.clone()
    mine = ta.update_kv_cache(kct, vct, knt, vnt, cache_len)
    ref = ja.update_kv_cache(kcj, vcj, knj, vnj, jnp.int32(cache_len))
    for got, want in zip(mine, ref):
        assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(_f32(got), _f32(want))
    assert torch.equal(kct, before)
