"""Remat "offload" as the reference computes it.

The reference's policy (``repro.core.streaming.remat_policy("offload")``
on a backend with memory kinds) is ``save_and_offload_only_these_names(
names_which_can_be_saved=[], names_which_can_be_offloaded=["residual"])``,
and no tensor of its models is named "residual": it saves nothing,
offloads nothing and recomputes as ``nothing_saveable`` ("full") does.
These tests hold both halves of that: the reference's ``jax.grad`` jaxpr
under "offload" equals "full"'s less the policy's name (with its memory-kind
probe forced true, as on an accelerator), and the port's ``loss_fn`` under
"offload" saves what "full" saves, on the input's device, runs the same
operations (the recompute included) and gives the same loss and gradients
bit for bit, also with the port's host tier faked present, as on a card.
All comparisons are exact."""
import collections
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core import streaming as jstreaming  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import streaming  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

ARCHS = ("qwen2-7b", "starcoder2-3b", "nemotron-4-15b", "qwen2-72b", "qwen2-vl-2b",
         "musicgen-medium", "mixtral-8x22b", "grok-1-314b", "rwkv6-3b", "hymba-1.5b")
B, S = 2, 16
POLICY = re.compile(r"policy=<function \S+ at 0x[0-9a-f]+>")


def _batch(cfg, seed=0) -> dict:
    """A seeded train batch as NumPy (tokens or embeds, labels)."""
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        toks = rng.integers(0, cfg.vocab_size, (B, S, cfg.num_codebooks), dtype=np.int32)
        return {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    labels = rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)
    if cfg.family == "vlm":
        return {"embeds": rng.standard_normal((B, S, cfg.d_model)).astype(np.float32),
                "labels": labels}
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32),
            "labels": labels}


class _CountOps(TorchDispatchMode):
    """Counts each operation that reaches the dispatcher."""

    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] += 1
        return func(*args, **(kwargs or {}))


def _run(model, batch, cfg, remat):
    """The port's ``loss_fn`` under ``remat`` and its gradients: (what the
    forward pass saves for the backward pass, as ``saved_tensors_hooks``
    sees it: shape, dtype and device each; the operations of the forward
    and backward passes, counted; the loss; the gradients)."""
    saved = []

    def pack(t):
        saved.append((tuple(t.shape), t.dtype, t.device))
        return t

    with _CountOps() as ops:
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            loss = tt.loss_fn(model, batch, cfg, remat=remat)
        grads = torch.autograd.grad(loss, list(model.parameters()))
    return saved, ops.counts, loss.detach(), grads


@pytest.mark.parametrize("arch", ARCHS)
def test_offload_saves_what_full_saves_on_the_device(arch, monkeypatch):
    """Under "offload" the port's ``loss_fn`` saves the tensors "full"
    saves (fewer than "none"), every one on the input's device, recomputes
    as "full" does (the same operations forward and backward, more than
    "none" runs) and gives "full"'s loss and gradients bit for bit, with the
    host tier faked present as on a card."""
    monkeypatch.setattr(streaming, "backend_supports_memory_kinds", lambda device=None: True)
    cfg = tconfigs.get_config(arch).model.reduce()
    model = tt.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    dev = next(model.parameters()).device
    runs = {kind: _run(model, batch, cfg, kind) for kind in ("none", "full", "offload")}
    saved, ops, loss, grads = runs["offload"]
    full, none = runs["full"], runs["none"]
    assert saved == full[0]
    assert len(saved) < len(none[0])
    assert all(d == dev for _, _, d in saved)
    assert ops == full[1]
    assert sum(ops.values()) > sum(none[1].values())
    assert torch.equal(loss, full[2])
    assert all(torch.equal(g, h) for g, h in zip(grads, full[3], strict=True))


@pytest.mark.parametrize("arch", ("qwen2-7b", "mixtral-8x22b", "rwkv6-3b", "hymba-1.5b"))
def test_reference_offload_computes_what_nothing_saveable_computes(arch, monkeypatch):
    """The reference's "offload" policy, with its memory-kind probe forced
    true: the ``jax.grad`` jaxpr of its ``loss_fn`` (a ``lax.scan`` over a
    checkpointed layer) equals the one under "full" (``nothing_saveable``)
    once the policies' names are taken out, where "dots" gives another."""
    monkeypatch.setattr(jstreaming, "backend_supports_memory_kinds", lambda: True)
    assert "save_and_offload_only_these_names" in repr(jstreaming.remat_policy("offload"))
    cfg = jconfigs.get_config(arch).model.reduce()
    tree = jax.jit(lambda k: jt.init_params(k, cfg))(jax.random.key(0))
    batch = _batch(cfg)

    def jaxpr(remat):
        text = str(jax.make_jaxpr(jax.grad(
            lambda p: jt.loss_fn(p, batch, cfg, remat=remat)))(tree))
        return POLICY.sub("policy=*", text), len(POLICY.findall(text))

    (offload, n), (full, m) = jaxpr("offload"), jaxpr("full")
    assert n == m >= 1
    assert offload == full
    assert jaxpr("dots")[0] != full
