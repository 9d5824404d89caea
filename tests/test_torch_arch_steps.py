"""``bench/lm_bench.py::arch_step_rows`` times the computations the
reference's ``benchmarks/lm_bench.py::arch_step_rows`` jits: each body of
``step_bodies``, called once on the CPU from the reference's weights
(``interop.params_from_jax``) and the same seeded inputs, gives the
reference's ``jax.value_and_grad(loss_fn)`` and its ``decode_step(...)[0]``
at position 3 of zero caches.

Tolerances: the loss at rel 1e-5; the gradients at atol 1e-5, rtol 1e-4
and the decode logits at 1e-4, those of tests/test_torch_models.py for the
reduced fp32 models."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.bench import lm_bench  # noqa: E402
from repro_torch.interop import params_from_jax  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
LOGIT_TOL = 1e-4


def _inputs(cfg, seed=0) -> tuple[dict, dict]:
    """(train batch, decode batch) as NumPy at the benchmark's B x S, the
    reference's layout for each family."""
    B, S = lm_bench.ARCH_B, lm_bench.ARCH_S
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        toks = rng.integers(0, cfg.vocab_size, (B, S, cfg.num_codebooks), dtype=np.int32)
        return ({"tokens": toks, "labels": toks},
                {"tokens": np.zeros((B, cfg.num_codebooks), np.int32)})
    step = {"tokens": np.zeros((B,), np.int32)}
    if cfg.family == "vlm":
        return ({"embeds": rng.standard_normal((B, S, cfg.d_model)).astype(np.float32),
                 "labels": rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)}, step)
    toks = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    return {"tokens": toks, "labels": toks}, step


def _stacked(model, grads) -> dict:
    """The port's gradients, by parameter, in the reference's tree layout
    (the blocks' stacked along a leading L)."""
    by_name = dict(zip([n for n, p in model.named_parameters() if p.requires_grad], grads,
                       strict=True))
    out = {}
    for name in by_name:
        parts = name.split(".")
        if parts[0] == "blocks":
            if parts[1] != "0":
                continue
            inner = ".".join(parts[2:])
            value = torch.stack([by_name[f"blocks.{i}.{inner}"]
                                 for i in range(len(model.blocks))])
            parts = ["layers", *parts[2:]]
        else:
            value = by_name[name]
        node = out
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return out


@pytest.mark.parametrize("arch", ("qwen2-7b", "rwkv6-3b", "mixtral-8x22b"))
def test_step_bodies_compute_what_the_reference_jits(arch):
    """One dense, one scan and one MoE config: the train body's loss and
    gradients and the decode body's logits against the reference's jitted
    functions on the same weights and inputs."""
    jcfg = jconfigs.get_config(arch).model.reduce()
    cfg = tconfigs.get_config(arch).model.reduce()
    tree = jax.jit(lambda k: jt.init_params(k, jcfg))(jax.random.key(0))
    model = params_from_jax(tree, cfg, "cpu")
    batch, step = _inputs(cfg)
    B, S = lm_bench.ARCH_B, lm_bench.ARCH_S
    train, decode = lm_bench.step_bodies(
        model, {k: torch.from_numpy(v) for k, v in batch.items()},
        {k: torch.from_numpy(v).long() for k, v in step.items()},
        tt.init_caches(cfg, B, S, "cpu"), cfg)

    loss, grads = train()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want_loss, want_grads = jax.jit(jax.value_and_grad(
        lambda p: jt.loss_fn(p, jb, jcfg)))(tree)
    assert loss.item() == pytest.approx(float(want_loss), rel=LOSS_RTOL)
    got = _stacked(model, grads)
    for path, w in jax.tree_util.tree_leaves_with_path(want_grads):
        g = got
        for k in path:
            g = g[k.key]
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=jax.tree_util.keystr(path))

    logits = decode()
    want = jax.jit(lambda p, b, c: jt.decode_step(p, b, c, jnp.int32(3), jcfg)[0])(
        tree, {k: jnp.asarray(v) for k, v in step.items()}, jt.init_caches(jcfg, B, S))
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), atol=LOGIT_TOL,
                               rtol=LOGIT_TOL)
