"""The port's MoE, Mamba SSM and RWKV6 modules (``repro_torch.models.{moe,
ssm,rwkv}``) and the serving pieces of the moe, ssm and hybrid families
against the JAX package on the same seeded NumPy inputs and the reference's
parameters carried across.

Tolerances are the other port tests': 1e-5 for the building blocks on
O(1) values, 1e-4 for the logits and caches of reduced models.  Routing is
compared exactly: the same (token, choice) pairs kept in the same slots,
in train (capacity factor 1.25, groups of the token count's divisor) and
decode (2.0, a group of the batch) settings.  The reference's decode
capacity drops pairs (ROADMAP.md §3), and the port drops the same ones."""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import rwkv as jrwkv  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.interop import params_from_jax, to_torch  # noqa: E402
from repro_torch.launch.serve import rehome_caches  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import rwkv as trwkv  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

ATOL = 1e-5
LOGIT_TOL = 1e-4


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _close(got, want, atol, rtol=0.0):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=rtol)


def _load(module, tree, noise_seed=None):
    """Copy the reference's param dict ``tree`` into ``module`` (every
    parameter, by its dotted path); with ``noise_seed``, N(0, 0.1) noise
    first goes on the leaves the reference inits to constants."""
    rng = np.random.default_rng(noise_seed)
    names = [n for n, _ in module.named_parameters()]
    assert len(names) == len(jax.tree.leaves(tree))
    for name in names:
        leaf = tree
        for part in name.split("."):
            leaf = leaf[part]
        a = np.asarray(leaf)
        if noise_seed is not None and name.split(".")[-1] in (
                "mu_r", "mu_k", "mu_v", "mu_g", "mu_w", "w0", "conv_b", "dt_bias",
                "A_log", "D", "scale", "bias"):
            a = a + rng.normal(0, 0.1, a.shape).astype(a.dtype)
        with torch.no_grad():
            module.get_parameter(name).copy_(to_torch(a, "cpu"))
        leaf_path = name.split(".")
        node = tree
        for part in leaf_path[:-1]:
            node = node[part]
        node[leaf_path[-1]] = jnp.asarray(a)
    return module, tree


def _rand(rng, *shape, scale=1.0):
    a = (rng.standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _moe_pair(d, f, e, activation, seed=0):
    pj = jmoe.init_moe(jax.random.key(seed), d, f, e, activation, jnp.float32)
    pj = dict(pj)
    return _load(tmoe.MoE(d, f, e, activation, torch.float32, "cpu"), pj)


def _dispatch_combine(gate, expert, slot, keep, e, capacity):
    """The port's routing as the reference's (G,S,E,C) dispatch and combine."""
    onehot = (torch.nn.functional.one_hot(expert, e)[..., None]
              * torch.nn.functional.one_hot(slot.clamp_max(capacity - 1), capacity)[..., None, :]
              * keep[..., None, None])                       # (G,S,k,E,C)
    return onehot.sum(2).float(), (onehot * gate[..., None, None]).sum(2)


# (B, S, group_size, capacity_factor): train (2 groups, default 1.25) and
# decode (one token a sequence, a group of the batch, 2.0)
SETTINGS = {"train": (2, 32, 32, tmoe.CAPACITY_FACTOR), "decode": (8, 1, 8, 2.0)}


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_routing_matches_jax(setting):
    B, S, group, cf = SETTINGS[setting]
    d, e, k = 16, 8, 2
    rng = np.random.default_rng(1)
    xj, xt = _rand(rng, B * S // group, group, d)
    rj, rt = _rand(rng, d, e, scale=d ** -0.5)
    capacity = max(k, int(group * k * cf / e))
    dj, cj, auxj = jmoe._routing(xj, rj, k, capacity, e)
    gate, expert, slot, keep, auxt = tmoe._routing(xt, rt, k, capacity, e)
    dt, ct = _dispatch_combine(gate, expert, slot, keep, e, capacity)
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
    _close(ct, cj, ATOL)
    _close(auxt, auxj, ATOL)
    assert keep.dtype == torch.bool and slot.dtype == torch.int64


@pytest.mark.parametrize("setting", sorted(SETTINGS))
@pytest.mark.parametrize("activation", ["swiglu", "geglu", "gelu", "squared_relu"])
def test_moe_matches_jax(activation, setting):
    """The whole layer, each activation (grok's experts are geglu, with
    jax.nn.gelu's tanh form), in the train and decode settings."""
    B, S, group, cf = SETTINGS[setting]
    d, f, e = 16, 24, 8
    mod, pj = _moe_pair(d, f, e, activation, seed=2)
    xj, xt = _rand(np.random.default_rng(3), B, S, d)
    yj, auxj = jmoe.moe(pj, xj, top_k=2, activation=activation, capacity_factor=cf,
                        group_size=group)
    yt, auxt = tmoe.moe(mod, xt, top_k=2, activation=activation, capacity_factor=cf,
                        group_size=group)
    _close(yt, yj, ATOL)
    _close(auxt, auxj, ATOL)


def test_decode_capacity_drops_as_the_reference():
    """The reference's decode MoE (capacity factor 2.0, a group of the
    batch) is not drop-free: at B 8, E 8, top 2 each expert takes 4 pairs.
    All 8 tokens choose experts 0 and 1; tokens 0-3 fill both, tokens 4-7
    lose both choices, and their MoE output is exactly zero, in the port as
    in the reference."""
    d, f, e, B = 16, 24, 8, 8
    mod, pj = _moe_pair(d, f, e, "swiglu", seed=4)
    router = np.full((d, e), -1.0, np.float32)
    router[:, 0], router[:, 1] = 2.0, 1.0
    pj["router"] = jnp.asarray(router)
    with torch.no_grad():
        mod.router.copy_(torch.from_numpy(router))
    x = np.abs(np.random.default_rng(5).standard_normal((B, 1, d))).astype(np.float32)
    yj, _ = jmoe.moe(pj, jnp.asarray(x), top_k=2, activation="swiglu", capacity_factor=2.0,
                     group_size=B)
    yt, _ = tmoe.moe(mod, torch.from_numpy(x), top_k=2, activation="swiglu",
                     capacity_factor=2.0, group_size=B)
    _close(yt, yj, ATOL)
    yt = yt.detach()
    assert not yt[4:].any() and np.all(np.asarray(yj)[4:] == 0)
    assert yt[:4].abs().amin(-1).gt(0).all()
    _, expert, slot, keep, _ = tmoe._routing(torch.from_numpy(x).reshape(1, B, d),
                                             mod.router, 2, 4, e)
    assert expert[0].tolist() == [[0, 1]] * B
    assert slot[0].tolist() == [[i, i] for i in range(B)]
    assert keep[0].tolist() == [[True, True]] * 4 + [[False, False]] * 4


def test_top_k_ties_go_to_the_lower_index():
    """jax.lax.top_k gives a tie to the lower index; torch.topk promises no
    order, so the port sorts stably.  Probabilities tied exactly: all
    experts (a zero router), and experts 1, 2 and 3 behind expert 0."""
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25],
                          [0.4, 0.2, 0.2, 0.2],
                          [0.1, 0.3, 0.3, 0.3],
                          [0.2, 0.2, 0.1, 0.5]])
    for k in (1, 2, 3):
        vt, it = tmoe._top_k(probs, k)
        vj, ij = jax.lax.top_k(jnp.asarray(probs.numpy()), k)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    d, e = 16, 8
    mod, pj = _moe_pair(d, 24, e, "swiglu", seed=6)
    pj["router"] = jnp.zeros((d, e))
    with torch.no_grad():
        mod.router.zero_()
    x = np.random.default_rng(7).standard_normal((2, 8, d)).astype(np.float32)
    dj, _, _ = jmoe._routing(jnp.asarray(x), pj["router"], 2, 16, e)
    _, expert, slot, keep, _ = tmoe._routing(torch.from_numpy(x), mod.router, 2, 16, e)
    assert (expert == torch.tensor([0, 1])).all()
    np.testing.assert_array_equal(
        _dispatch_combine(torch.ones(expert.shape), expert, slot, keep, e, 16)[0].numpy(),
        np.asarray(dj))


def test_moe_refuses_a_group_that_does_not_divide_the_tokens():
    mod, _ = _moe_pair(16, 24, 4, "swiglu")
    with pytest.raises(ValueError, match="groups of 8"):
        tmoe.moe(mod, torch.zeros(3, 4, 16), top_k=2, activation="swiglu", group_size=8)


# ---------------------------------------------------------------------------
# Mamba SSM
# ---------------------------------------------------------------------------

def _mamba_pair(d=16, d_inner=24, n=4, seed=8):
    pj = dict(jssm.init_ssm(jax.random.key(seed), d, d_inner, n, jnp.float32))
    return _load(tssm.Mamba(d, d_inner, n, torch.float32, "cpu"), pj, noise_seed=seed)


@pytest.mark.parametrize("S", [2 * jssm.SSM_CHUNK, 12])
def test_ssm_scan_matches_jax(S):
    """Both of the reference's branches: S a multiple of SSM_CHUNK and
    past it (chunks scanned in sequence), and one chunk."""
    assert tssm.SSM_CHUNK == jssm.SSM_CHUNK and tssm.CONV_K == jssm.CONV_K
    mod, pj = _mamba_pair()
    xj, xt = _rand(np.random.default_rng(9), 2, S, 24)
    yj, hj = jssm.ssm_scan(pj, jax.nn.silu(xj))
    yt, ht = tssm.ssm_scan(mod, torch.nn.functional.silu(xt))
    _close(yt, yj, ATOL)
    _close(ht, hj, ATOL)


def test_ssm_step_and_mamba_with_a_carried_state():
    """ssm_step against JAX from a random state; mamba over a prompt, then
    decode steps carrying (conv_state, ssm_state), each step's output and
    states against JAX's; the conv state is the last CONV_K-1 inputs."""
    mod, pj = _mamba_pair()
    rng = np.random.default_rng(10)
    xj, xt = _rand(rng, 2, 24)
    sj, st = _rand(rng, 2, 24, 4)
    for got, want in zip(tssm.ssm_step(mod, xt, st), jssm.ssm_step(pj, xj, sj)):
        _close(got, want, ATOL)

    xj, xt = _rand(rng, 2, 10, 16)
    yj, statej = jssm.mamba(pj, xj[:, :6])
    yt, statet = tssm.mamba(mod, xt[:, :6])
    _close(yt, yj, ATOL)
    for got, want in zip(statet, statej):
        _close(got, want, ATOL)
    xin = (xt[:, :6] @ mod.in_proj).chunk(2, dim=-1)[0]
    _close(statet[0], xin[:, -(tssm.CONV_K - 1):], 0)
    for i in range(6, 10):
        yj, statej = jssm.mamba(pj, xj[:, i:i + 1], state=statej)
        yt, statet = tssm.mamba(mod, xt[:, i:i + 1], state=statet)
        _close(yt, yj, ATOL)
        for got, want in zip(statet, statej):
            _close(got, want, ATOL)
    init = tssm.init_mamba_state(2, 24, 4, torch.bfloat16, "cpu")
    want = jssm.init_mamba_state(2, 24, 4, jnp.bfloat16)
    assert [(tuple(a.shape), a.dtype) for a in init] == [
        (tuple(a.shape), to_torch(a, "cpu").dtype) for a in want]


# ---------------------------------------------------------------------------
# RWKV6
# ---------------------------------------------------------------------------

def _rwkv_cfg():
    return jconfigs.get_config("rwkv6-3b").model.reduce()


def _rwkv_pair(seed=11):
    cfg = _rwkv_cfg()
    pj = jax.tree.map(lambda a: a, jrwkv.init_rwkv_layer(jax.random.key(seed), cfg,
                                                          jnp.float32))
    return (*_load(trwkv.RWKVBlock(cfg, torch.float32, "cpu"), pj, noise_seed=seed), cfg)


@pytest.mark.parametrize("S", [2 * jrwkv.WKV_CHUNK, 12])
def test_wkv6_scan_matches_jax(S):
    """Both branches of the reference: S a multiple of WKV_CHUNK past it
    (checkpointed chunks), and a plain scan; from a random state."""
    assert (trwkv.WKV_CHUNK, trwkv.DECAY_LORA) == (jrwkv.WKV_CHUNK, jrwkv.DECAY_LORA)
    B, H, N = 2, 3, 8
    rng = np.random.default_rng(12)
    (rj, rt), (kj, kt), (vj, vt) = (_rand(rng, B, S, H, N) for _ in range(3))
    wa = rng.uniform(0.5, 1.0, (B, S, H, N)).astype(np.float32)
    (uj, ut), (sj, st) = _rand(rng, H, N), _rand(rng, B, H, N, N)
    yj, s2j = jrwkv.wkv6_scan(rj, kj, vj, jnp.asarray(wa), uj, sj)
    yt, s2t = trwkv.wkv6_scan(rt, kt, vt, torch.from_numpy(wa), ut, st)
    _close(yt, yj, ATOL, 1e-5)
    _close(s2t, s2j, ATOL, 1e-5)


def test_time_and_channel_mix_with_carried_shifts():
    """time_mix and channel_mix over a prompt, then one token at a time
    from the carried shifts and WKV state, against JAX; then the whole
    block, and the data-dependent decay."""
    mod, pj, cfg = _rwkv_pair()
    rng = np.random.default_rng(13)
    xj, xt = _rand(rng, 2, 9, cfg.d_model)
    _close(trwkv.data_dependent_decay(xt, mod.tm), jrwkv.data_dependent_decay(xj, pj["tm"]),
           ATOL)
    yj, (shj, wkvj) = jrwkv.time_mix(pj["tm"], xj[:, :5], cfg)
    yt, (sht, wkvt) = trwkv.time_mix(mod.tm, xt[:, :5], cfg)
    cj, cshj = jrwkv.channel_mix(pj["cm"], xj[:, :5])
    ct, csht = trwkv.channel_mix(mod.cm, xt[:, :5])
    for got, want in ((yt, yj), (wkvt, wkvj), (ct, cj)):
        _close(got, want, ATOL)
    _close(sht, xt[:, 4], 0)
    _close(csht, xt[:, 4], 0)
    for i in range(5, 9):
        yj, (shj, wkvj) = jrwkv.time_mix(pj["tm"], xj[:, i:i + 1], cfg, shift_state=shj,
                                        wkv_state=wkvj)
        yt, (sht, wkvt) = trwkv.time_mix(mod.tm, xt[:, i:i + 1], cfg, shift_state=sht,
                                        wkv_state=wkvt)
        cj, cshj = jrwkv.channel_mix(pj["cm"], xj[:, i:i + 1], shift_state=cshj)
        ct, csht = trwkv.channel_mix(mod.cm, xt[:, i:i + 1], shift_state=csht)
        for got, want in ((yt, yj), (wkvt, wkvj), (ct, cj), (sht, shj), (csht, cshj)):
            _close(got, want, ATOL)
    xj2, statej = jrwkv.rwkv_block(pj, xj, cfg)
    xt2, statet = trwkv.rwkv_block(mod, xt, cfg)
    _close(xt2, xj2, ATOL)
    for got, want in zip(statet, statej):
        _close(got, want, ATOL)
    init = trwkv.init_rwkv_state(cfg, 2, torch.bfloat16, "cpu")
    want = jrwkv.init_rwkv_state(cfg, 2, jnp.bfloat16)
    assert [(tuple(a.shape), a.dtype) for a in init] == [
        (tuple(a.shape), to_torch(a, "cpu").dtype) for a in want]


# ---------------------------------------------------------------------------
# The families' caches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["rwkv6-3b", "hymba-1.5b"])
def test_init_caches_match_jax(arch):
    """Names, shapes and dtypes of the decode caches of a bf16 model at
    full width (JAX's only traced): rwkv's shifts in bf16 and WKV state in
    fp32; hybrid's window-sized K/V, conv state in bf16, SSM state fp32."""
    cfg = tconfigs.get_config(arch).model
    want = jax.eval_shape(lambda: jt.init_caches(cfg, 8, 4096))
    got = tt.init_caches(cfg, 8, 4096, "meta")
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert tuple(got[name].shape) == w.shape, name
        assert str(got[name].dtype) == f"torch.{jnp.dtype(w.dtype).name}", name


def _reduced_pair(arch, seed=0):
    cfg = jconfigs.get_config(arch).model.reduce()
    tree = jax.jit(lambda k: jt.init_params(k, cfg))(jax.random.key(seed))
    return cfg, tree, params_from_jax(tree, cfg, "cpu")


@pytest.mark.parametrize("arch", ["rwkv6-3b", "hymba-1.5b"])
def test_decode_step_writes_the_recurrent_states_in_place(arch):
    """The port's deliberate difference, for the recurrent states too:
    decode_step writes them into the caches it is given and returns the
    same tensors."""
    cfg, _, model = _reduced_pair(arch)
    caches = tt.init_caches(cfg, 2, 8, "cpu")
    ids = {name: id(c) for name, c in caches.items()}
    before = {name: c.clone() for name, c in caches.items()}
    _, out = tt.decode_step(model, {"tokens": torch.tensor([1, 2])}, caches, 0, cfg)
    assert out is caches and {name: id(c) for name, c in out.items()} == ids
    for name in ("tm_shift", "cm_shift", "wkv") if cfg.family == "ssm" else ("conv", "ssm"):
        assert not torch.equal(out[name], before[name]), name


def _teacher_forced(cfg, tree, model, toks, prompt):
    """Prefill ``prompt`` tokens, re-home the caches as serve does, then
    decode the rest teacher-forced: each step's logits and the final
    caches, in JAX and in the port."""
    B, total = toks.shape
    lj, cj = jax.jit(lambda t, b: jt.prefill(t, b, cfg))(tree, {"tokens": jnp.asarray(toks[:, :prompt])})
    lt, ct = tt.prefill(model, {"tokens": torch.from_numpy(toks[:, :prompt])}, cfg)
    cj_full = jt.init_caches(cfg, B, total)
    for name in ("k", "v"):
        s_cache = min(cj_full[name].shape[2], cj[name].shape[2])
        cj_full[name] = jax.lax.dynamic_update_slice_in_dim(
            cj_full[name], cj[name][:, :, -s_cache:], 0, axis=2)
    cj_full.update(conv=cj["conv"], ssm=cj["ssm"])
    ct_full = rehome_caches(cfg, ct, B, total, "cpu")
    step = jax.jit(lambda t, b, c, n: jt.decode_step(t, b, c, n, cfg))
    outs = [(lt, lj)]
    for i in range(prompt, total - 1):
        lj, cj_full = step(tree, {"tokens": jnp.asarray(toks[:, i])}, cj_full, jnp.int32(i))
        lt, ct_full = tt.decode_step(model, {"tokens": torch.from_numpy(toks[:, i])},
                                     ct_full, i, cfg)
        outs.append((lt, lj))
    return outs, ct_full, cj_full


def test_hymba_ring_buffer_matches_jax():
    """Reduced hymba (window 64): a 96-token prompt fills the window-sized
    ring with its last 64 positions, and decode past it wraps the ring;
    each step's logits and every cache tensor as in JAX."""
    cfg, tree, model = _reduced_pair("hymba-1.5b", seed=1)
    assert cfg.sliding_window == 64
    toks = np.random.default_rng(14).integers(0, cfg.vocab_size, (2, 104)).astype(np.int32)
    outs, ct, cj = _teacher_forced(cfg, tree, model, toks, 96)
    assert ct["k"].shape[2] == 64
    for lt, lj in outs:
        _close(lt, lj, LOGIT_TOL)
    for name in ("k", "v", "conv", "ssm"):
        _close(ct[name], cj[name], LOGIT_TOL)


@pytest.mark.parametrize("prompt", [64, 128, 80])
def test_ring_after_a_prompt_past_the_window(prompt):
    """An inconsistency of the reference that the port keeps
    (ROADMAP.md §3): serve copies a prefill's last `window` K/V rows into
    ring slots 0..window-1, but decode writes position p into slot
    p % window.  With a prompt that is a multiple of the window the two
    agree and decode reproduces the full forward; with prompt 80 and
    window 64 the ring holds a position outside the window and loses one
    inside it, and decode leaves the full forward, in JAX and in the
    port alike."""
    cfg, tree, model = _reduced_pair("hymba-1.5b", seed=2)
    toks = np.random.default_rng(15).integers(0, cfg.vocab_size, (1, prompt + 5)).astype(np.int32)
    outs, _, _ = _teacher_forced(cfg, tree, model, toks, prompt)
    with torch.no_grad():
        full = model({"tokens": torch.from_numpy(toks)})[0, prompt - 1:-1].numpy()
    port = np.stack([_np(lt)[0] for lt, _ in outs])
    ref = np.stack([_np(lj)[0] for _, lj in outs])
    _close(port, ref, LOGIT_TOL)
    gap = np.abs(port - full).max(axis=-1)
    if prompt % cfg.sliding_window == 0:
        assert gap.max() < 1e-4
    else:
        assert gap[0] < 1e-4 and gap[1:].max() > 2e-2


# ---------------------------------------------------------------------------
# chip_smoke's family checks, on narrow copies of the models
# ---------------------------------------------------------------------------

def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


NARROW = {  # full depth (mixtral: chip_smoke's fp32 check depth), narrow widths
    "rwkv6-3b": dict(d_model=256, d_ff=896, vocab_size=4096),
    "hymba-1.5b": dict(d_model=320, num_heads=5, num_kv_heads=1, head_dim=64, d_ff=1088,
                       vocab_size=4096),
    "mixtral-8x22b": dict(d_model=512, num_heads=8, num_kv_heads=2, head_dim=64, d_ff=1024,
                          vocab_size=4096),
}


@pytest.mark.parametrize("arch", sorted(NARROW))
def test_family_check_limit_separates_bf16_from_the_faults(arch):
    """chip_smoke's bf16 limit on a narrow copy of each family (random
    weights, 64 tokens, the fp32 run routed as the bf16 run,
    ``chip_smoke.routing``): bf16 stays well inside it and the family's
    injected fault (``chip_smoke.family_fault``) lands far outside."""
    cs = _chip_smoke()
    base = tconfigs.get_config(arch).model
    layers = cs.FAMILY_CHECK_LAYERS.get(arch, base.num_layers)
    limit = cs.FAMILY_BF16_LOGIT_REL.get(arch, cs.BF16_LOGIT_REL)
    cfg = dataclasses.replace(base, num_layers=layers, **NARROW[arch])
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    g = torch.Generator().manual_seed(0)
    params = tt.init_params(cfg, g, "cpu")
    prompt = {"tokens": torch.randint(0, cfg.vocab_size, (1, 64), generator=g)}
    choices = []
    with cs.routing(choices):
        got = tt.prefill(params, prompt, cfg)[0].float()
    assert len(choices) == (layers if cfg.num_experts else 0)
    params.float()

    def fp32():
        with cs.routing(choices, replay=True):
            return tt.prefill(params, prompt, cfg32)[0]

    want = fp32()

    def rel(x):
        return float((x - want).norm() / want.norm())

    with cs.family_fault(params) as label:
        fault = rel(fp32())
    assert rel(fp32()) == 0.0  # the fault was undone
    assert rel(got) < 0.75 * limit
    assert fault > 2 * limit, label


def test_routing_replay_holds_the_bf16_choices():
    """``chip_smoke.routing`` replays recorded expert choices: on a narrow
    2-layer mixtral whose fp32 run flips some of the bf16 run's choices
    (seed 15: 6 of 256), its own routing leaves the bf16 logits 0.50 of
    their norm away, the replayed routing 0.011."""
    cs = _chip_smoke()
    cfg = dataclasses.replace(tconfigs.get_config("mixtral-8x22b").model, num_layers=2,
                              **NARROW["mixtral-8x22b"])
    g = torch.Generator().manual_seed(15)
    params = tt.init_params(cfg, g, "cpu")
    prompt = {"tokens": torch.randint(0, cfg.vocab_size, (1, 64), generator=g)}
    choices, own = [], []
    with cs.routing(choices):
        got = tt.prefill(params, prompt, cfg)[0].float()
    params.float()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    with cs.routing(own):
        unrouted = tt.prefill(params, prompt, cfg32)[0]
    with cs.routing(choices, replay=True):
        routed = tt.prefill(params, prompt, cfg32)[0]
    assert sum(int((a != b).sum()) for a, b in zip(choices, own)) > 0
    assert float((got - unrouted).norm() / unrouted.norm()) > 2 * cs.BF16_LOGIT_REL
    assert float((got - routed).norm() / routed.norm()) < cs.BF16_LOGIT_REL / 2


def test_rwkv_bf16_gap_is_the_reference_s():
    """Why rwkv6-3b's bf16 limit is its own: on a narrow copy at full depth
    the reference's bf16 logits are further from its fp32 logits than the
    other models' limit allows, the port's bf16 path, on the same weights,
    leaves fp32 by the same amount (within 20 %), and both stay inside
    rwkv's limit."""
    cs = _chip_smoke()
    cfg = dataclasses.replace(jconfigs.get_config("rwkv6-3b").model, **NARROW["rwkv6-3b"])
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    tree = jax.jit(lambda k: jt.init_params(k, cfg))(jax.random.key(0))
    tree32 = jax.tree.map(lambda a: a.astype(jnp.float32), tree)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (1, 64)).astype(np.int32)
    lj16, lj32 = (np.asarray(jax.jit(lambda t, b, c=c: jt.prefill(t, b, c))(
        t, {"tokens": jnp.asarray(toks)})[0], np.float32) for t, c in ((tree, cfg), (tree32, cfg32)))
    model = params_from_jax(tree, cfg, "cpu")
    lt16 = _np(tt.prefill(model, {"tokens": torch.from_numpy(toks)}, cfg)[0])
    model.float()
    lt32 = _np(tt.prefill(model, {"tokens": torch.from_numpy(toks)}, cfg32)[0])
    _close(lt32, lj32, LOGIT_TOL)
    gap_j = np.linalg.norm(lj16 - lj32) / np.linalg.norm(lj32)
    gap_t = np.linalg.norm(lt16 - lt32) / np.linalg.norm(lt32)
    assert gap_j > cs.BF16_LOGIT_REL
    assert abs(gap_t - gap_j) < 0.2 * gap_j
    assert max(gap_j, gap_t) < cs.FAMILY_BF16_LOGIT_REL["rwkv6-3b"]


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch", ["mixtral-8x22b", "rwkv6-3b", "hymba-1.5b"])
def test_remat_policies_cover_the_new_blocks(arch, remat):
    """The remat policies wrap the MoE, RWKV6 and hybrid blocks as they
    wrap the dense one, and change no arithmetic: loss (with the MoE aux)
    and gradients equal "none"'s at 1e-6."""
    cfg, _, model = _reduced_pair(arch, seed=3)
    toks = np.random.default_rng(16).integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(np.roll(toks, -1, 1))}
    results = {}
    for kind in ("none", remat):
        model.zero_grad()
        loss = tt.loss_fn(model, batch, cfg, remat=kind)
        loss.backward()
        results[kind] = (loss.detach(), {n: p.grad.clone() for n, p in model.named_parameters()})
    _close(results[remat][0], results["none"][0], 1e-6)
    for name, grad in results["none"][1].items():
        _close(results[remat][1][name], grad, 1e-6)
