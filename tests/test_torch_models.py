"""The port's model code (``repro_torch.models``: common, mlp, the FSDP
query-chunk branch of attention and the transformer of all ten configs)
against the JAX package on the same inputs: seeded NumPy data, and the
reference's parameter tree carried across with ``params_from_jax`` after
seeded noise is added to the biases, norm scales, token-shift mixes and
the SSM constants (which the reference inits to constants, which would
hide their paths).

Tolerances: the building blocks at 1e-5, the JAX tests' own
(tests/test_attention_and_data.py); fp32 logits and losses of the reduced
models at 1e-4 (two frameworks summing 2-layer products in other orders);
gradients at atol 1e-5, rtol 1e-4; the FSDP query-chunk attention and the
chunked loss at the JAX tests' rtol 1e-5 / atol 1e-5
(tests/test_perf_variants.py); prefill + decode against the full forward
inside the port at the JAX test's 2e-2 (tests/test_models_smoke.py), and
both against JAX at 1e-4.  The remat policies change no arithmetic, so
they agree with "none" at 1e-6."""
import dataclasses
import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import attention as ja  # noqa: E402
from repro.models import common as jc  # noqa: E402
from repro.models import mlp as jmlp  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import streaming  # noqa: E402
from repro_torch.interop import params_from_jax, to_torch  # noqa: E402
from repro_torch.launch.serve import rehome_caches  # noqa: E402
from repro_torch.models import attention as ta  # noqa: E402
from repro_torch.models import common as tc  # noqa: E402
from repro_torch.models import mlp as tmlp  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

ARCHS = ("qwen2-7b", "qwen2-72b", "starcoder2-3b", "nemotron-4-15b", "qwen2-vl-2b",
         "musicgen-medium", "mixtral-8x22b", "grok-1-314b", "rwkv6-3b", "hymba-1.5b")
# leaves the reference inits to constants: noise makes each path show
NOISY = ("bq", "bk", "bv", "scale", "bias", "mu_r", "mu_k", "mu_v", "mu_g", "mu_w",
         "w0", "conv_b", "dt_bias", "A_log", "D")
ATOL = 1e-5
LOGIT_TOL = 1e-4
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def _restore_mode():
    yield
    jc.set_sharding_mode("2d")
    tc.set_sharding_mode("2d")


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=rtol)


def _cfg(arch):
    return jconfigs.get_config(arch).model.reduce()


_PARAMS = {}


def _params(cfg, seed=0):
    """The reference's params for ``cfg`` with N(0, 0.1) noise on every leaf
    named in ``NOISY``, as a JAX tree and as the port's module."""
    key = (cfg, seed)
    if key not in _PARAMS:
        tree = jax.jit(lambda k: jt.init_params(k, cfg))(jax.random.key(seed))
        rng = np.random.default_rng(seed + 100)

        def noisy(path, leaf):
            name = path[-1].key
            if name in NOISY:
                return leaf + jnp.asarray(rng.normal(0, 0.1, leaf.shape), leaf.dtype)
            return leaf

        tree = jax.tree_util.tree_map_with_path(noisy, tree)
        _PARAMS[key] = (tree, params_from_jax(tree, cfg, "cpu"))
    return _PARAMS[key]


def _batch(cfg, B=2, S=16, seed=0):
    """A seeded train batch as NumPy (tokens or embeds, labels)."""
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        toks = rng.integers(0, cfg.vocab_size, (B, S, cfg.num_codebooks), dtype=np.int32)
        return {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    if cfg.family == "vlm":
        t = np.arange(S, dtype=np.int32)
        thw = np.stack([t // 4, t % 4, t % 3], -1)  # distinct streams
        return {"embeds": rng.standard_normal((B, S, cfg.d_model)).astype(np.float32),
                "labels": rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32),
                "positions_thw": np.broadcast_to(thw, (B, S, 3)).copy()}
    toks = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    return {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}


@functools.cache
def _jit_hidden(cfg):
    """The reference's final hidden states (after the final norm), jitted."""
    def hidden(tree, batch):
        x, pos = jt.embed_inputs(tree, batch, cfg)
        return jt.backbone(tree, x, cfg, pos)[0]
    return jax.jit(hidden)


@functools.cache
def _jit_prefill(cfg):
    return jax.jit(lambda tree, batch: jt.prefill(tree, batch, cfg))


@functools.cache
def _jit_decode(cfg):
    return jax.jit(lambda tree, batch, caches, n: jt.decode_step(tree, batch, caches, n, cfg))


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _tb(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _port_tree(model, leaf) -> dict:
    """``leaf(parameter)`` of each of the port's parameters, in the
    reference's tree layout (the blocks' stacked along a leading L)."""
    out = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "blocks":
            if parts[1] != "0":
                continue
            inner = ".".join(parts[2:])
            parts = ["layers", *parts[2:]]
            value = torch.stack([leaf(b.get_parameter(inner)) for b in model.blocks])
        else:
            value = leaf(p)
        node = out
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return out


def _port_grads(model) -> dict:
    return _port_tree(model, lambda p: p.grad)


def _assert_tree_close(got, want, atol, rtol):
    flat_want = jax.tree_util.tree_leaves_with_path(want)
    for path, w in flat_want:
        g = got
        for k in path:
            g = g[k.key]
        np.testing.assert_allclose(_np(g), _np(w), atol=atol, rtol=rtol,
                                   err_msg=jax.tree_util.keystr(path))


# ---------------------------------------------------------------------------
# common and mlp
# ---------------------------------------------------------------------------

def _rand(rng, *shape):
    a = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def test_norms_match_jax():
    rng = np.random.default_rng(0)
    (xj, xt), (sj, st), (bj, bt) = _rand(rng, 2, 5, 32), _rand(rng, 32), _rand(rng, 32)
    _close(tc.rmsnorm(xt, st), jc.rmsnorm(xj, sj), ATOL)
    _close(tc.layernorm(xt, st, bt), jc.layernorm(xj, sj, bj), ATOL)
    _close(tc.apply_norm(xt, {"scale": st, "bias": bt}, "layernorm"),
           jc.apply_norm(xj, {"scale": sj, "bias": bj}, "layernorm"), ATOL)
    # bf16: statistics in fp32, cast back before the scale, as the reference
    xb = jnp.asarray(xj, jnp.bfloat16)
    got = tc.rmsnorm(to_torch(np.asarray(xb), "cpu"), st.to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    _close(got, jc.rmsnorm(xb, jnp.asarray(sj, jnp.bfloat16)), 2e-2)


@pytest.mark.parametrize("name", ["gelu", "silu", "squared_relu", "relu"])
def test_activations_match_jax(name):
    xj, xt = _rand(np.random.default_rng(1), 64)
    _close(tc.ACTIVATIONS[name](xt * 3), jc.ACTIVATIONS[name](xj * 3), ATOL)


def test_gelu_is_the_tanh_form():
    """jax.nn.gelu defaults to the tanh approximation; torch's default is
    the erf form, which differs by more than the tolerance."""
    x = torch.linspace(-4, 4, 101)
    _close(tc.gelu(x), jax.nn.gelu(jnp.asarray(x.numpy())), ATOL)
    assert (tc.gelu(x) - torch.nn.functional.gelu(x)).abs().max() > 1e-4


def test_rope_and_mrope_match_jax():
    rng = np.random.default_rng(2)
    (qj, qt), (kj, kt) = _rand(rng, 2, 7, 4, 16), _rand(rng, 2, 7, 2, 16)
    pos = rng.integers(0, 5000, (2, 7)).astype(np.int32)
    for got, want in zip(tc.apply_rope(qt, kt, torch.from_numpy(pos), 1e6),
                         jc.apply_rope(qj, kj, jnp.asarray(pos), 1e6)):
        _close(got, want, 1e-4)  # angles of ~5000 rad lose ~1e-4 in fp32
    thw = rng.integers(0, 64, (2, 7, 3)).astype(np.int32)
    for got, want in zip(tc.apply_mrope(qt, kt, torch.from_numpy(thw), 1e4),
                         jc.apply_mrope(qj, kj, jnp.asarray(thw), 1e4)):
        _close(got, want, ATOL)
    np.testing.assert_array_equal(
        tc.text_mrope_positions(torch.from_numpy(pos)).numpy(),
        np.asarray(jc.text_mrope_positions(jnp.asarray(pos))))


def test_embed_unembed_and_loss_match_jax():
    rng = np.random.default_rng(3)
    (ej, et), (e3j, e3t) = _rand(rng, 40, 8), _rand(rng, 4, 40, 8)
    toks = rng.integers(0, 40, (2, 5)).astype(np.int32)
    toks3 = rng.integers(0, 40, (2, 5, 4)).astype(np.int32)
    _close(tc.embed_tokens(et, torch.from_numpy(toks)), jc.embed_tokens(ej, toks), 0)
    _close(tc.embed_tokens(e3t, torch.from_numpy(toks3)), jc.embed_tokens(e3j, toks3), ATOL)
    _close(tc.embed_tokens(e3t, torch.from_numpy(toks)), jc.embed_tokens(e3j, toks), 0)
    xj, xt = _rand(rng, 2, 5, 8)
    _close(tc.unembed(xt, et), jc.unembed(xj, ej), ATOL)
    _close(tc.unembed(xt, e3t), jc.unembed(xj, e3j), ATOL)
    labels = toks.copy()
    labels[0, :2] = -1  # ignored
    lt, lj = tc.unembed(xt, et), jc.unembed(xj, ej)
    _close(tc.cross_entropy_loss(lt, torch.from_numpy(labels)),
           jc.cross_entropy_loss(lj, jnp.asarray(labels)), ATOL)
    _close(tc.cross_entropy_loss(tc.unembed(xt, e3t), torch.from_numpy(toks3)),
           jc.cross_entropy_loss(jc.unembed(xj, e3j), jnp.asarray(toks3)), ATOL)


@pytest.mark.parametrize("activation", ["swiglu", "geglu", "gelu", "squared_relu"])
def test_mlp_matches_jax(activation):
    d, f = 16, 40
    pj = jmlp.init_mlp(jax.random.key(4), d, f, activation, jnp.float32)
    mod = tmlp.MLP(d, f, activation, torch.float32, "cpu")
    with torch.no_grad():
        for name, w in pj.items():
            getattr(mod, name).copy_(torch.from_numpy(np.array(w)))
    xj, xt = _rand(np.random.default_rng(5), 3, 6, d)
    _close(mod(xt), jmlp.mlp(pj, xj, activation), ATOL)
    assert sorted(n for n, _ in mod.named_parameters()) == sorted(pj)


def test_sharding_mode_state():
    for mode in ("2d", "fsdp", "zero1"):
        tc.set_sharding_mode(mode)
        jc.set_sharding_mode(mode)
        assert (tc.get_sharding_mode(), tc.get_param_mode()) == (
            jc.get_sharding_mode(), jc.get_param_mode())
    with pytest.raises(ValueError):
        tc.set_sharding_mode("3d")
    x = torch.ones(2)
    assert tc.shard_hint(x, ("data",)) is x


# ---------------------------------------------------------------------------
# The reduced models, JAX weights carried across
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_is_a_copy(arch):
    cfg = _cfg(arch)
    tree, model = _params(cfg)
    if cfg.family != "ssm":
        assert model.blocks[0].attn.wq.shape == (cfg.d_model, cfg.num_heads * cfg.head_dim)
    _assert_tree_close(_port_tree(model, torch.Tensor.detach), tree, 0, 0)
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(x.size for x in jax.tree.leaves(tree))
    with pytest.raises(ValueError, match="trees differ"):
        params_from_jax({**tree, "extra": np.zeros(3)}, cfg, "cpu")
    layers = dict(tree["layers"])
    layers.pop(sorted(layers)[0])
    with pytest.raises(ValueError, match="trees differ"):  # a missing leaf
        params_from_jax({**tree, "layers": layers}, cfg, "cpu")


def test_params_from_jax_carries_bf16_bit_for_bit():
    cfg = dataclasses.replace(_cfg("qwen2-7b"), dtype="bfloat16")
    tree = jax.jit(lambda k: jt.init_params(k, cfg))(jax.random.key(3))
    model = params_from_jax(tree, cfg, "cpu")
    got = model.blocks[1].attn.wq.detach()
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(tree["layers"]["attn"]["wq"][1]).view(np.int16))
    with pytest.raises(ValueError, match="float32"):  # a tree of another dtype
        params_from_jax(tree, dataclasses.replace(cfg, dtype="float32"), "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_keeps_every_leaf_dtype_and_bits(arch):
    """Every leaf of a bf16 model arrives with JAX's dtype and bits: bf16
    leaves bit for bit, and the fp32 leaves (router, SSM and decay
    parameters) as fp32."""
    cfg = dataclasses.replace(_cfg(arch), dtype="bfloat16")
    tree = jax.jit(lambda k: jt.init_params(k, cfg))(jax.random.key(3))
    got = _port_tree(params_from_jax(tree, cfg, "cpu"), torch.Tensor.detach)
    dtypes = set()
    for path, want in jax.tree_util.tree_leaves_with_path(tree):
        g = got
        for k in path:
            g = g[k.key]
        want = np.asarray(want)
        dtypes.add(want.dtype.name)
        assert str(g.dtype) == f"torch.{want.dtype.name}", jax.tree_util.keystr(path)
        bits = {2: (torch.int16, np.int16), 4: (torch.int32, np.int32)}[want.dtype.itemsize]
        np.testing.assert_array_equal(g.view(bits[0]).numpy(), want.view(bits[1]),
                                      err_msg=jax.tree_util.keystr(path))
    assert "bfloat16" in dtypes
    assert ("float32" in dtypes) == (cfg.family in ("moe", "ssm", "hybrid"))


@pytest.mark.parametrize("arch", ARCHS)
def test_backbone_logits_loss_and_grads_match_jax(arch):
    cfg = _cfg(arch)
    tree, model = _params(cfg)
    batch = _batch(cfg)
    hj = _jit_hidden(cfg)(tree, _jb(batch))
    xt, pt = tt.embed_inputs(model, _tb(batch), cfg)
    ht, _ = tt.backbone(model, xt, cfg, pt)
    _close(ht, hj, LOGIT_TOL)
    _close(tt.logits_fn(model, ht, cfg), jt.logits_fn(tree, hj, cfg), LOGIT_TOL)

    lj, gj = jax.jit(jax.value_and_grad(
        lambda p, b: jt.loss_fn(p, b, cfg, remat="none")))(tree, _jb(batch))
    model.zero_grad()
    lt = tt.loss_fn(model, _tb(batch), cfg, remat="none")
    lt.backward()
    _close(lt, lj, LOGIT_TOL)
    _assert_tree_close(_port_grads(model), gj, GRAD_ATOL, GRAD_RTOL)
    model.zero_grad()


def _jax_rehome(cfg, cp, B, max_seq):
    """The reference serve's caches for decoding after a prefill's ``cp``
    (src/repro/launch/serve.py)."""
    if cfg.family == "ssm":
        return cp
    caches = jt.init_caches(cfg, B, max_seq)
    s_cache = min(caches["k"].shape[2], cp["k"].shape[2])
    for name in ("k", "v"):
        caches[name] = jax.lax.dynamic_update_slice_in_dim(
            caches[name], cp[name][:, :, -s_cache:], 0, axis=2)
    for name in ("conv", "ssm"):
        if name in caches:
            caches[name] = cp[name]
    return caches


def _close_caches(got, want, atol):
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == to_torch(want[name], "cpu").dtype, name
        np.testing.assert_allclose(_np(got[name]), _np(want[name]), atol=atol, err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    """Logits and every cache tensor (K/V; rwkv's shifts and WKV state;
    hybrid's K/V and Mamba states) after a prefill and after each
    teacher-forced decode step."""
    cfg = _cfg(arch)
    tree, model = _params(cfg)
    B, S, extra = 2, 12, 3
    full = _batch(cfg, B, S + extra, seed=1)
    toks_key = "embeds" if cfg.family == "vlm" else "tokens"
    pre = {toks_key: full[toks_key][:, :S]}
    lj, cj = _jit_prefill(cfg)(tree, _jb(pre))
    lt, ct = tt.prefill(model, _tb(pre), cfg)
    _close(lt, lj, LOGIT_TOL)
    _close_caches(ct, cj, LOGIT_TOL)

    # teacher-forced decode of the next `extra` tokens
    cj_full = _jax_rehome(cfg, cj, B, S + extra)
    ct_full = rehome_caches(cfg, ct, B, S + extra, "cpu")
    toks = full["tokens"] if "tokens" in full else full["labels"]
    for i in range(extra):
        step = toks[:, S + i - 1]
        lj, cj_full = _jit_decode(cfg)(tree, {"tokens": jnp.asarray(step)}, cj_full,
                                       jnp.int32(S + i))
        lt, ct_full = tt.decode_step(model, {"tokens": torch.from_numpy(step)}, ct_full,
                                     S + i, cfg)
        _close(lt, lj, LOGIT_TOL)
        _close_caches(ct_full, cj_full, LOGIT_TOL)


@pytest.mark.parametrize("arch", ("qwen2-7b", "musicgen-medium", "starcoder2-3b",
                                  "rwkv6-3b", "hymba-1.5b"))
def test_prefill_decode_matches_full_forward(arch):
    """Teacher-forced decode after prefill reproduces the full forward's
    last logits, in the port (at the JAX test's 2e-2) and as in JAX."""
    cfg = _cfg(arch)
    tree, model = _params(cfg)
    B, S, extra = 1, 16, 4
    toks = _batch(cfg, B, S + extra, seed=2)["tokens"]
    full_t = model({"tokens": torch.from_numpy(toks)})[:, -1]
    full_j = jt.logits_fn(tree, _jit_hidden(cfg)(tree, {"tokens": jnp.asarray(toks)}),
                          cfg)[:, -1]
    _close(full_t.detach(), full_j, LOGIT_TOL)

    _, c = tt.prefill(model, {"tokens": torch.from_numpy(toks[:, :S])}, cfg)
    caches = rehome_caches(cfg, c, B, S + extra, "cpu")
    for i in range(extra):
        out, caches = tt.decode_step(model, {"tokens": torch.from_numpy(toks[:, S + i])},
                                     caches, S + i, cfg)
    _close(out, full_t.detach(), 2e-2, 2e-2)
    _close(out, full_j, LOGIT_TOL)


def test_sliding_window_ring_buffer_matches_jax():
    """A dense model with a window: window-sized caches, and decode past the
    window wraps the ring as the reference does."""
    cfg = dataclasses.replace(_cfg("qwen2-7b"), sliding_window=8)
    tree, model = _params(cfg)
    assert tt.init_caches(cfg, 2, 10 * 8, "cpu")["k"].shape[2] == 8
    B, S = 2, 6
    toks = _batch(cfg, B, S + 8, seed=3)["tokens"]
    lj, cj = _jit_prefill(cfg)(tree, {"tokens": jnp.asarray(toks[:, :S])})
    lt, ct = tt.prefill(model, {"tokens": torch.from_numpy(toks[:, :S])}, cfg)
    _close(lt, lj, LOGIT_TOL)
    cj_full, ct_full = jt.init_caches(cfg, B, 64), tt.init_caches(cfg, B, 64, "cpu")
    for name in ("k", "v"):
        cj_full[name] = cj_full[name].at[:, :, :S].set(cj[name])
        ct_full[name][:, :, :S] = ct[name]
    for i in range(8):  # cache_len 6..13 wraps the 8-slot ring
        step = toks[:, S + i]
        lj, cj_full = _jit_decode(cfg)(tree, {"tokens": jnp.asarray(step)}, cj_full,
                                       jnp.int32(S + i))
        lt, ct_full = tt.decode_step(model, {"tokens": torch.from_numpy(step)}, ct_full,
                                     S + i, cfg)
        _close(lt, lj, LOGIT_TOL)
    _close(ct_full["v"], cj_full["v"], LOGIT_TOL)


def test_vocab_padding_masked():
    """A 31-token vocab pads to 256 columns; the padding never wins."""
    cfg = dataclasses.replace(_cfg("qwen2-7b"), vocab_size=31)
    assert cfg.padded_vocab == 256
    tree, model = _params(cfg)
    toks = np.random.default_rng(4).integers(0, 31, (2, 8)).astype(np.int32)
    got = model({"tokens": torch.from_numpy(toks)}).detach()
    assert int(got.argmax(-1).max()) < cfg.vocab_size
    assert bool((got[..., 31:] == -1e30).all())
    want = jt.logits_fn(tree, _jit_hidden(cfg)(tree, {"tokens": jnp.asarray(toks)}), cfg)
    _close(got[..., :31], np.asarray(want)[..., :31], LOGIT_TOL)


def test_decode_step_writes_the_caches_in_place():
    """The port's deliberate difference: decode_step writes the new K/V row
    into the caches it is given and returns the same tensors; the other
    rows stay as they were."""
    cfg = _cfg("qwen2-7b")
    _, model = _params(cfg)
    caches = tt.init_caches(cfg, 2, 8, "cpu")
    caches["k"].normal_()
    before = caches["k"].clone()
    k_id, v_id = id(caches["k"]), id(caches["v"])
    _, out = tt.decode_step(model, {"tokens": torch.tensor([1, 2])}, caches, 3, cfg)
    assert out is caches and id(out["k"]) == k_id and id(out["v"]) == v_id
    changed = (out["k"] != before).flatten(3).any(-1)  # (L, B, S)
    assert changed[:, :, 3].all() and not changed[:, :, [0, 1, 2, 4, 5, 6, 7]].any()
    assert out["v"][:, :, 3].abs().sum() > 0 and not out["v"][:, :, 4:].any()


# ---------------------------------------------------------------------------
# The perf variants: FSDP query-chunk attention, chunked CE, remat
# ---------------------------------------------------------------------------

def test_fsdp_qchunk_attention_matches_dense_and_jax(monkeypatch):
    B, S, Hq, Hkv, Dh = 1, 128, 4, 2, 16
    rng = np.random.default_rng(6)
    arrays = [rng.standard_normal((B, S, h, Dh)).astype(np.float32) for h in (Hq, Hkv, Hkv)]
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in arrays)
    base = ta.attention(q, k, v, causal=True)
    win_base = ta.attention(q, k, v, causal=True, window=40)
    monkeypatch.setattr(ta, "FSDP_Q_CHUNK", 32)
    monkeypatch.setattr(ja, "FSDP_Q_CHUNK", 32)
    tc.set_sharding_mode("fsdp")
    jc.set_sharding_mode("fsdp")
    chunked = ta.attention(q, k, v, causal=True)
    win = ta.attention(q, k, v, causal=True, window=40)
    _close(chunked.detach(), base.detach(), 1e-5)
    _close(win.detach(), win_base.detach(), 1e-5)
    jq, jk, jv = map(jnp.asarray, arrays)

    def jloss(q, k, v):
        return jnp.sum(jnp.sin(ja.attention(q, k, v, causal=True, window=40)))

    _close(win.detach(), jax.jit(lambda q, k, v: ja.attention(
        q, k, v, causal=True, window=40))(jq, jk, jv), 1e-5)
    gj = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(jq, jk, jv)
    torch.sin(win).sum().backward()
    for t, j in zip((q, k, v), gj):
        _close(t.grad, j, 1e-5, 1e-5)


def test_chunked_ce_and_grads_match_dense_and_jax(monkeypatch):
    cfg = _cfg("starcoder2-3b")
    tree, model = _params(cfg)
    rng = np.random.default_rng(7)
    B, S = 2, 32
    xa = (rng.standard_normal((B, S, cfg.d_model)) * 0.3).astype(np.float32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[0, :3] = -1
    x, lab = torch.from_numpy(xa), torch.from_numpy(labels)
    dense = tc.cross_entropy_loss(tt.logits_fn(model, x, cfg), lab)
    dense.backward()
    g_dense = model.embedding.grad.clone()
    model.zero_grad()
    monkeypatch.setattr(tt, "CE_CHUNK", 8)
    monkeypatch.setattr(jt, "CE_CHUNK", 8)
    chunked = tt._chunked_ce(model, x, lab, cfg)
    chunked.backward()
    _close(chunked.detach(), dense.detach(), 0, 1e-5)
    _close(model.embedding.grad, g_dense, 1e-5)
    gj = jax.jit(jax.grad(lambda p: jt._chunked_ce(
        p, jnp.asarray(xa), jnp.asarray(labels), cfg, unroll=False)))(tree)["embedding"]
    _close(model.embedding.grad, gj, 1e-5)
    _close(chunked.detach(),
           jt._chunked_ce(tree, jnp.asarray(xa), jnp.asarray(labels), cfg, unroll=True),
           0, 1e-5)
    model.zero_grad()


def test_loss_under_fsdp_takes_the_chunked_loss(monkeypatch):
    """Under fsdp, loss_fn takes the chunked CE and the query-chunked
    attention, and gives JAX's loss and the 2d loss."""
    cfg = _cfg("qwen2-7b")
    tree, model = _params(cfg)
    batch = _batch(cfg, 2, 32, seed=8)
    base = tt.loss_fn(model, _tb(batch), cfg, remat="none").item()
    monkeypatch.setattr(tt, "CE_CHUNK", 8)
    monkeypatch.setattr(ta, "FSDP_Q_CHUNK", 8)
    monkeypatch.setattr(jt, "CE_CHUNK", 8)
    monkeypatch.setattr(ja, "FSDP_Q_CHUNK", 8)
    calls = []
    real = tt._chunked_ce
    monkeypatch.setattr(tt, "_chunked_ce", lambda *a: calls.append(1) or real(*a))
    tc.set_sharding_mode("fsdp")
    jc.set_sharding_mode("fsdp")
    got = tt.loss_fn(model, _tb(batch), cfg, remat="none").item()
    assert calls
    assert got == pytest.approx(base, rel=1e-5)
    want = jax.jit(lambda p, b: jt.loss_fn(p, b, cfg, remat="none"))(tree, _jb(batch))
    assert got == pytest.approx(float(want), rel=1e-5)


@pytest.mark.parametrize("remat", ["full", "dots", "offload"])
def test_remat_policies_give_the_same_loss_and_grads(remat):
    cfg = _cfg("nemotron-4-15b")
    _, model = _params(cfg)
    batch = _tb(_batch(cfg, 2, 16, seed=9))
    results = {}
    for kind in ("none", remat):
        model.zero_grad()
        loss = tt.loss_fn(model, batch, cfg, remat=kind)
        loss.backward()
        results[kind] = (loss.detach(), {n: p.grad.clone() for n, p in model.named_parameters()})
    model.zero_grad()
    _close(results[remat][0], results["none"][0], 1e-6)
    for name, g in results["none"][1].items():
        _close(results[remat][1][name], g, 1e-6)


def test_remat_policy_names():
    for kind in streaming.REMAT_KINDS:
        assert callable(streaming.remat_policy(kind))
    assert streaming.remat_policy("offload") is streaming.remat_policy("full")
    with pytest.raises(ValueError, match="unknown remat policy"):
        streaming.remat_policy("some")
    with pytest.raises(ValueError, match="unknown remat policy"):
        streaming.checkpoint_layer(lambda x: x, "some")
    f = lambda x: x  # noqa: E731
    assert streaming.checkpoint_layer(f, "none") is f


def test_dots_saves_the_matrix_products_only():
    """Under "dots" the backward recomputes everything but mm/addmm/bmm."""
    policy = streaming.remat_policy("dots")
    save = torch.utils.checkpoint.CheckpointPolicy.MUST_SAVE
    assert policy(None, torch.ops.aten.mm.default) is save
    assert policy(None, torch.ops.aten.bmm.default) is save
    assert policy(None, torch.ops.aten.exp.default) is not save


def test_model_check_limit_separates_bf16_from_the_faults():
    """chip_smoke's bf16 limit on a narrow qwen2-7b (all 28 layers, d 512,
    random weights, 64 tokens): bf16 stays well inside it, and both
    injected faults (wo of WO_FAULT_LAYER zeroed; queries rotated one
    position ahead of the keys in ROPE_FAULT_LAYER) land far outside.  The
    same RoPE fault in a middle layer moves the logits less than bf16
    does: with random weights attention there is near uniform, which is
    why the fault sits in layer 0."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    base = tconfigs.get_config("qwen2-7b").model
    cfg = dataclasses.replace(base, d_model=512, num_heads=4, num_kv_heads=1,
                              head_dim=128, d_ff=2560, vocab_size=4096)
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    g = torch.Generator().manual_seed(0)
    params = tt.init_params(cfg, g, "cpu")
    prompt = {"tokens": torch.randint(0, cfg.vocab_size, (1, 64), generator=g)}
    got = tt.prefill(params, prompt, cfg)[0].float()
    params.float()
    want = tt.prefill(params, prompt, cfg32)[0]

    def rel(x):
        return float((x - want).norm() / want.norm())

    def with_rope_fault(layer):
        rotate, calls = tt._rotate, [0]

        def off_by_one(q, k, positions, c):
            i, calls[0] = calls[0], calls[0] + 1
            if i != layer:
                return rotate(q, k, positions, c)
            return rotate(q, k, positions + 1, c)[0], rotate(q, k, positions, c)[1]

        tt._rotate = off_by_one
        try:
            return rel(tt.prefill(params, prompt, cfg32)[0])
        finally:
            tt._rotate = rotate

    wo = params.blocks[cs.WO_FAULT_LAYER].attn.wo
    saved = wo.detach().clone()
    with torch.no_grad():
        wo.zero_()
    fault_wo = rel(tt.prefill(params, prompt, cfg32)[0])
    with torch.no_grad():
        wo.copy_(saved)
    bf16 = rel(got)
    assert bf16 < cs.BF16_LOGIT_REL / 2
    assert fault_wo > 2 * cs.BF16_LOGIT_REL
    assert with_rope_fault(cs.ROPE_FAULT_LAYER) > 2 * cs.BF16_LOGIT_REL
    assert with_rope_fault(14) < bf16
