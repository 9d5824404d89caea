"""The port's serve step as the reference compiles it: ``decode_step`` with
``cache_len`` a 0-d int32 tensor (the reference traces it as an int32
scalar under ``jax.jit``) against JAX's ``decode_step`` with
``jnp.int32(cache_len)`` on the same seeded caches, for every reduced
config, a ring past its window (hymba) and a slot clamped at the cache's
end (dense); the tensor path bit for bit the int path; no host read and no
data-dependent shape inside the step (a ``TorchDispatchMode`` that raises on
``aten._local_scalar_dense``, ``aten.nonzero`` and the masked selections);
and ``serve`` decoding
through ``launch.step.build_serve_step``, its logits kept apart when the
step rewrites one buffer.  The step's CUDA graph is captured only on a
card, by ``chip_smoke.py``.

Tolerance: logits and caches at 1e-4, tests/test_torch_serve.py's (fp32,
two frameworks summing the products in other orders)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from _torch_host_reads import NoHostRead  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch.configs import ARCH_NAMES, get_config  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import step as tstep  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

B = 2
LOGIT_TOL = 1e-4
# (arch, max_seq, the cache lengths of two steps): every reduced config
# inside its cache; hymba's 64-slot ring past the window; a dense cache
# whose slot clamps at its last row
CASES = ([pytest.param(n, 12, (5, 6), id=n) for n in ARCH_NAMES]
         + [pytest.param("hymba-1.5b", 80, (70, 71), id="hymba-1.5b-ring"),
            pytest.param("qwen2-7b", 12, (12, 15), id="qwen2-7b-clamp")])


def _setup(name, max_seq, seed=0):
    """JAX's params and the port's copy, seeded NumPy caches (nonzero, so
    that every valid row counts), and the tokens of two steps."""
    cfg = jconfigs.get_config(name).model.reduce()
    tree = jt.init_params(jax.random.key(seed), cfg)
    rng = np.random.default_rng(seed + 1)
    caches = {k: (0.5 * rng.standard_normal(v.shape)).astype(np.float32)
              for k, v in jt.init_caches(cfg, B, max_seq).items()}
    shape = (2, B, cfg.num_codebooks) if cfg.family == "audio" else (2, B)
    toks = rng.integers(0, cfg.vocab_size, shape).astype(np.int32)
    return cfg, tree, params_from_jax(tree, cfg, "cpu"), caches, toks


def _torch_caches(caches):
    return {k: torch.from_numpy(v.copy()) for k, v in caches.items()}


@pytest.mark.parametrize("name,max_seq,lens", CASES)
def test_decode_step_with_a_device_cache_len_matches_jax(name, max_seq, lens):
    cfg, tree, model, caches, toks = _setup(name, max_seq)
    if max_seq > 64:  # the ring case: 64 slots, both steps past the window
        assert caches["k"].shape[2] == cfg.sliding_window < lens[0]
    step = jax.jit(lambda p, b, c, n: jt.decode_step(p, b, c, n, cfg))
    jc = {k: jnp.asarray(v) for k, v in caches.items()}
    tc = _torch_caches(caches)
    for i, n in enumerate(lens):
        jl, jc = step(tree, {"tokens": jnp.asarray(toks[i])}, jc, jnp.int32(n))
        tl, out = tt.decode_step(model, {"tokens": torch.from_numpy(toks[i])}, tc,
                                 torch.tensor(n, dtype=torch.int32), cfg)
        assert out is tc
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=LOGIT_TOL,
                                   err_msg=f"logits at cache_len {n}")
        for k in tc:
            np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k], np.float32),
                                       atol=LOGIT_TOL, err_msg=f"{k} at cache_len {n}")


@pytest.mark.parametrize("name,max_seq,lens", CASES)
def test_tensor_cache_len_is_the_int_path_bit_for_bit(name, max_seq, lens):
    cfg, _, model, caches, toks = _setup(name, max_seq)
    by_int, by_tensor = _torch_caches(caches), _torch_caches(caches)
    for i, n in enumerate(lens):
        batch = {"tokens": torch.from_numpy(toks[i])}
        li, _ = tt.decode_step(model, batch, by_int, n, cfg)
        lt, _ = tt.decode_step(model, batch, by_tensor, torch.tensor(n, dtype=torch.int32), cfg)
        assert torch.equal(li, lt), f"logits at cache_len {n}"
        for k in by_int:
            assert torch.equal(by_int[k], by_tensor[k]), f"{k} at cache_len {n}"


class _NoHostRead(NoHostRead):
    where = "the decode step"


def test_the_mode_catches_host_reads():
    t = torch.tensor([3, 0, 2])
    with _NoHostRead():
        for read in (lambda: int(t[0]), lambda: t.nonzero(), lambda: t[t > 0],
                     lambda: t.masked_select(t > 0)):
            with pytest.raises(RuntimeError, match="inside the decode step"):
                read()


@pytest.mark.parametrize("name,max_seq,lens", CASES)
def test_decode_step_reads_nothing_on_the_host(name, max_seq, lens):
    cfg, _, model, caches, toks = _setup(name, max_seq)
    tc = _torch_caches(caches)
    with _NoHostRead():
        for i, n in enumerate(lens):
            logits, _ = tt.decode_step(model, {"tokens": torch.from_numpy(toks[i])}, tc,
                                       torch.tensor(n, dtype=torch.int32), cfg)
    assert bool(torch.isfinite(logits).all())


def test_decode_step_refuses_a_cache_len_it_would_read_elsewhere():
    cfg, _, model, caches, toks = _setup("qwen2-7b", 12)
    batch = {"tokens": torch.from_numpy(toks[0])}
    for bad in (torch.tensor([5], dtype=torch.int32),
                torch.tensor(5, dtype=torch.int32, device="meta")):
        with pytest.raises(ValueError, match="cache_len must be an int or a 0-d tensor"):
            tt.decode_step(model, batch, _torch_caches(caches), bad, cfg)


def test_build_serve_step_on_the_cpu_and_on_a_mesh():
    """Without a mesh ``build_serve_step`` gives a ``GraphServeStep``: on caches on
    the CPU it runs the eager step (``capture`` does nothing) and keeps the
    step's logits in ``logits``; a step pinned to another device refuses
    them.  On a mesh it gives the eager function."""
    arch = get_config("qwen2-7b")
    arch = dataclasses.replace(arch, model=arch.model.reduce())
    cfg, _, model, caches, toks = _setup("qwen2-7b", 12)
    step = tstep.build_serve_step(arch)
    assert isinstance(step, tstep.GraphServeStep)
    batch, n = {"tokens": torch.from_numpy(toks[0])}, torch.tensor(5, dtype=torch.int32)
    step.capture(model, batch, _torch_caches(caches), n)
    assert step.graph is None
    nxt, out = step(model, batch, _torch_caches(caches), n)
    want, _ = tt.decode_step(model, batch, _torch_caches(caches), 5, cfg)
    assert torch.equal(step.logits, want) and torch.equal(nxt, want.argmax(-1))
    assert set(out) == {"k", "v"}
    with pytest.raises(ValueError, match="the step on meta"):
        tstep.build_serve_step(arch, device="meta")(model, batch, _torch_caches(caches), n)
    assert not isinstance(tstep.build_serve_step(arch, mesh=object()), tstep.GraphServeStep)


def test_serve_decodes_through_build_serve_step(monkeypatch):
    """serve builds its decode step with ``build_serve_step`` for the
    model it serves, captures it once before the first step, and calls it
    every step with ``cache_len`` a 0-d int32 tensor on the run's device
    that counts up from the prompt's length; the tokens are those of the
    serve that ``build_serve_step``'s own step gives."""
    real, calls = tstep.build_serve_step, []
    want = tserve.serve("qwen2-7b", batch=B, prompt_len=8, gen=5, device="cpu")

    def recording(arch, mesh=None, *, device=None):
        inner = real(arch, mesh, device=device)
        calls.append(("build", arch.model.name, mesh, device))

        class Step:
            def capture(self, params, batch, caches, cache_len):
                calls.append(("capture", int(cache_len)))
                inner.capture(params, batch, caches, cache_len)

            def __call__(self, params, batch, caches, cache_len):
                assert cache_len.shape == () and cache_len.dtype == torch.int32
                assert cache_len.device.type == "cpu"
                calls.append(("step", int(cache_len)))
                return inner(params, batch, caches, cache_len)

            @property
            def logits(self):
                return inner.logits

        return Step()

    monkeypatch.setattr(tserve, "build_serve_step", recording)
    got = tserve.serve("qwen2-7b", batch=B, prompt_len=8, gen=5, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert calls == [("build", "qwen2-7b", None, torch.device("cpu")), ("capture", 8),
                     ("step", 8), ("step", 9), ("step", 10), ("step", 11)]


def test_serve_keeps_each_steps_logits_apart(monkeypatch):
    """A captured step rewrites one logits buffer every replay: serve's
    record keeps a copy of each step's, not the buffer."""
    V = get_config("qwen2-7b").model.reduce().padded_vocab

    class OneBuffer:
        logits = torch.zeros(B, V)

        def capture(self, *args):
            pass

        def __call__(self, params, batch, caches, cache_len):
            self.logits.fill_(0.0)
            self.logits[:, int(cache_len) % V] = 1.0  # the step's mark
            return self.logits.argmax(dim=-1), caches

    monkeypatch.setattr(tserve, "build_serve_step", lambda *a, **k: OneBuffer())
    record = {}
    toks = tserve.serve("qwen2-7b", batch=B, prompt_len=8, gen=4, device="cpu",
                        record=record, keep_logits=True)
    kept = record["logits"][1:]
    assert len(kept) == 3 and all(x is not OneBuffer.logits for x in kept)
    for i, x in enumerate(kept):
        assert int(x.argmax(-1)[0]) == 8 + i
    np.testing.assert_array_equal(toks[:, 1:], [[8, 9, 10]] * B)
    assert record["capture_ms"] >= 0
