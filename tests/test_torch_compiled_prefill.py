"""The port's prefill step as the reference compiles it: ``build_prefill_step``
(a ``GraphPrefillStep``: one layer's body, ``transformer.prefill_layer``,
run on a slot layer that takes each layer's weights in turn) against the
reference's ``jax.jit`` of its prefill, for every reduced config, hymba's
K/V cut past its window and the vlm family's M-RoPE positions; the slot
path bit for bit the eager ``transformer.prefill`` (on other weights of the
same shapes too: the step is not bound to its params); no host read and no
data-dependent shape inside ``prefill_layer``; the step's argument checks;
chip_smoke's slot fault caught; and ``serve`` prefilling through
``build_prefill_step``.  On the CPU the step calls the body eagerly in place
of a replay: only the card captures the graph, in ``chip_smoke.py``.

Tolerance: logits and caches at 1e-4, tests/test_torch_models.py's
``test_prefill_and_decode_match_jax`` (fp32, two frameworks summing the
products in other orders); the slot path exactly."""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from _torch_host_reads import NoHostRead  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch.configs import ARCH_NAMES, get_config  # noqa: E402
from repro_torch.interop import params_from_jax, to_torch  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import step as tstep  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

B = 2
LOGIT_TOL = 1e-4
# leaves the reference inits to constants: noise makes each path show
NOISY = ("bq", "bk", "bv", "scale", "bias", "mu_r", "mu_k", "mu_v", "mu_g", "mu_w",
         "w0", "conv_b", "dt_bias", "A_log", "D")
# (arch, prompt length): every reduced config; hymba's prompt past its
# 64-position window, whose K/V the prefill cuts to the window
CASES = ([pytest.param(n, 12, id=n) for n in ARCH_NAMES]
         + [pytest.param("hymba-1.5b", 80, id="hymba-1.5b-past-window")])


class _NoHostRead(NoHostRead):
    where = "the prefill layer"


def _arch(name):
    arch = get_config(name)
    return dataclasses.replace(arch, model=arch.model.reduce())


def _setup(name, seed=0):
    """JAX's params with N(0, 0.1) noise on the leaves named in ``NOISY``,
    and the port's copy."""
    cfg = jconfigs.get_config(name).model.reduce()
    tree = jax.jit(lambda k: jt.init_params(k, cfg))(jax.random.key(seed))
    rng = np.random.default_rng(seed + 100)

    def noisy(path, leaf):
        if path[-1].key in NOISY:
            return leaf + jnp.asarray(rng.normal(0, 0.1, leaf.shape), leaf.dtype)
        return leaf

    tree = jax.tree_util.tree_map_with_path(noisy, tree)
    return cfg, tree, params_from_jax(tree, cfg, "cpu")


def _prompt(cfg, S, seed=1) -> dict:
    """A seeded prompt batch as NumPy: tokens, or for the vlm family stub
    embeddings with three distinct M-RoPE position streams."""
    rng = np.random.default_rng(seed)
    if cfg.family == "vlm":
        t = np.arange(S, dtype=np.int32)
        thw = np.stack([t // 4, t % 4, t % 3], -1)
        return {"embeds": rng.standard_normal((B, S, cfg.d_model)).astype(np.float32),
                "positions_thw": np.broadcast_to(thw, (B, S, 3)).copy()}
    shape = (B, S, cfg.num_codebooks) if cfg.family == "audio" else (B, S)
    return {"tokens": rng.integers(0, cfg.vocab_size, shape).astype(np.int32)}


def _tb(batch):
    return {k: torch.from_numpy(v.copy()) for k, v in batch.items()}


def _assert_equal(got, want):
    (gl, gc), (wl, wc) = got, want
    assert torch.equal(gl, wl), "logits"
    assert sorted(gc) == sorted(wc)
    for k in wc:
        assert gc[k].dtype == wc[k].dtype and torch.equal(gc[k], wc[k]), k


@pytest.mark.parametrize("name,S", CASES)
def test_prefill_step_matches_jax_jit(name, S):
    cfg, tree, model = _setup(name)
    batch = _prompt(cfg, S)
    jl, jc = jax.jit(lambda p, b: jt.prefill(p, b, cfg))(
        tree, {k: jnp.asarray(v) for k, v in batch.items()})
    step = tstep.build_prefill_step(_arch(name))
    assert isinstance(step, tstep.GraphPrefillStep)
    nxt, tc = step(model, _tb(batch))
    assert torch.equal(nxt, step.logits.argmax(dim=-1))
    np.testing.assert_allclose(step.logits.float().numpy(), np.asarray(jl, np.float32),
                               atol=LOGIT_TOL, err_msg="logits")
    assert sorted(tc) == sorted(jc)
    for k in jc:
        assert tc[k].dtype == to_torch(jc[k], "cpu").dtype, k
        assert tc[k].shape[0] == cfg.num_layers
        np.testing.assert_allclose(tc[k].float().numpy(), np.asarray(jc[k], np.float32),
                                   atol=LOGIT_TOL, err_msg=k)
    if S > 64:
        assert tc["k"].shape[2] == cfg.sliding_window == 64 < S


@pytest.mark.parametrize("name,S", CASES)
def test_slot_path_is_the_eager_prefill_bit_for_bit(name, S):
    """The step's slot path gives ``transformer.prefill``'s bits; a second
    call gives them again, and a call on other weights of the same shapes
    gives that model's prefill (the slot takes the weights every call)."""
    cfg, _, model = _setup(name)
    batch = _tb(_prompt(cfg, S))
    step = tstep.build_prefill_step(_arch(name))
    want = tt.prefill(model, batch, cfg)
    for _ in range(2):
        _, caches = step(model, batch)
        _assert_equal((step.logits, caches), want)
    _, _, other = _setup(name, seed=3)
    _, caches = step(other, batch)
    _assert_equal((step.logits, caches), tt.prefill(other, batch, cfg))
    assert step.graph is None and step.capture_ms == 0.0


@pytest.mark.parametrize("name,S", CASES)
def test_prefill_layer_reads_nothing_on_the_host(name, S):
    cfg, _, model = _setup(name)
    x, positions = tt.embed_inputs(model, _tb(_prompt(cfg, S)), cfg)
    with torch.no_grad(), _NoHostRead():
        for blk in model.blocks:
            x, cache = tt.prefill_layer(blk, x, positions, cfg)
    assert bool(torch.isfinite(x).all())
    assert all(bool(torch.isfinite(c).all()) for c in cache.values())


def test_the_mode_catches_host_reads_in_a_layer():
    t = torch.tensor([3, 0, 2])
    with _NoHostRead(), pytest.raises(RuntimeError, match="inside the prefill layer"):
        int(t[0])


class _Copies(TorchDispatchMode):
    """Records each ``copy_`` and ``_foreach_copy_``: its name, its first
    destination's address and how many tensors it copies."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in (torch.ops.aten.copy_, torch.ops.aten._foreach_copy_):
            dst = args[0] if isinstance(args[0], (list, tuple)) else [args[0]]
            self.seen.append((func.overloadpacket.__name__, dst[0].data_ptr(), len(dst)))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("name", ("qwen2-7b", "rwkv6-3b", "hymba-1.5b"))
def test_the_slot_takes_a_layer_in_one_foreach_copy_a_dtype(name):
    """In bf16, where rwkv's and hymba's blocks and caches hold fp32
    tensors too, each layer's weights go into the slot, and its caches
    into the stacked caches, by one ``_foreach_copy_`` a dtype, never one
    ``copy_`` a tensor."""
    arch = _arch(name)
    cfg = dataclasses.replace(arch.model, dtype="bfloat16")
    model = tt.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    step = tstep.build_prefill_step(dataclasses.replace(arch, model=cfg))
    with _Copies() as copies:
        _, caches = step(model, _tb(_prompt(cfg, 12)))
    weights = list(model.blocks[0].parameters())
    slot = {w.data_ptr() for w in step.slot.parameters()}
    spans = [(c.data_ptr(), c.data_ptr() + c.numel() * c.element_size())
             for c in caches.values()]
    loads = [s for s in copies.seen if s[1] in slot]
    stores = [s for s in copies.seen if any(lo <= s[1] < hi for lo, hi in spans)]
    L = cfg.num_layers
    assert len({w.dtype for w in weights}) == (2 if cfg.family in ("ssm", "hybrid") else 1)
    assert {op for op, _, _ in loads + stores} == {"_foreach_copy_"}
    assert len(loads) == L * len({w.dtype for w in weights})
    assert sum(n for _, _, n in loads) == L * len(weights)
    assert len(stores) == L * len({c.dtype for c in caches.values()})
    assert sum(n for _, _, n in stores) == L * len(caches)


def _chip_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


@pytest.mark.parametrize("name", ("qwen2-7b", "rwkv6-3b", "hymba-1.5b", "mixtral-8x22b"))
def test_chip_smoke_catches_a_layer_left_out_of_the_slot(name):
    """``chip_smoke.slot_not_loaded``: a layer that runs on the slot's
    previous weights changes the logits, and the step is whole again after
    it."""
    cs = _chip_smoke()
    cfg, _, model = _setup(name)
    batch = _tb(_prompt(cfg, 12))
    step = tstep.build_prefill_step(_arch(name))
    want = tt.prefill(model, batch, cfg)
    with cs.slot_not_loaded(step, cfg.num_layers - 1):
        step(model, batch)
    assert not torch.equal(step.logits, want[0])
    _, caches = step(model, batch)
    _assert_equal((step.logits, caches), want)


def test_the_step_is_bound_to_its_batch_and_config():
    """Another prompt length, batch key or dtype raises, as do params of
    another depth, width or dtype; the step stays whole after each
    refusal.  On a mesh the step is the eager function."""
    arch = _arch("qwen2-7b")
    cfg, _, model = _setup("qwen2-7b")
    batch = _tb(_prompt(cfg, 12))
    step = tstep.build_prefill_step(arch)
    want = step(model, batch)[1]
    for bad in ({"tokens": batch["tokens"][:, :-1]}, {"tokens": batch["tokens"].long()},
                {"embeds": torch.zeros(B, 12, cfg.d_model)}):
        with pytest.raises(ValueError, match="bound to a batch"):
            step(model, bad)
    g = torch.Generator().manual_seed(0)
    for other, match in (
            (dataclasses.replace(cfg, num_layers=cfg.num_layers + 1), "layers"),
            (dataclasses.replace(cfg, d_ff=cfg.d_ff * 2), "parameters differ"),
            (dataclasses.replace(cfg, dtype="bfloat16"), "parameters differ")):
        with pytest.raises(ValueError, match=match):
            step(tt.init_params(other, g, "cpu"), batch)
    _, again = step(model, batch)
    assert all(torch.equal(again[k], want[k]) for k in want)
    assert not isinstance(tstep.build_prefill_step(arch, mesh=object()),
                          tstep.GraphPrefillStep)


def test_serve_prefills_through_build_prefill_step(monkeypatch):
    """serve builds its prefill step with ``build_prefill_step`` for the
    model it serves, calls it once on the prompt batch and keeps its logits; the tokens are those of the serve that
    ``build_prefill_step``'s own step gives, and the record carries the
    step's capture time (0 on the CPU)."""
    real, calls = tstep.build_prefill_step, []
    want = tserve.serve("qwen2-7b", batch=B, prompt_len=8, gen=4, device="cpu")

    def recording(arch, mesh=None):
        inner = real(arch, mesh)
        calls.append(("build", arch.model.name, arch.model.num_layers, mesh))

        class Step:
            capture_ms = 0.0

            def __call__(self, params, batch):
                calls.append(("prefill", tuple(batch), tuple(batch["tokens"].shape)))
                return inner(params, batch)

            @property
            def logits(self):
                return inner.logits

        return Step()

    monkeypatch.setattr(tserve, "build_prefill_step", recording)
    record = {}
    got = tserve.serve("qwen2-7b", batch=B, prompt_len=8, gen=4, device="cpu",
                       record=record, keep_logits=True)
    np.testing.assert_array_equal(got, want)
    L = get_config("qwen2-7b").model.reduce().num_layers
    assert calls == [("build", "qwen2-7b", L, None),
                     ("prefill", ("tokens",), (B, 8))]
    assert record["prefill_capture_ms"] == 0.0
    np.testing.assert_array_equal(record["logits"][0].argmax(-1).numpy(), want[:, 0])
