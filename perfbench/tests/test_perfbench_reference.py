"""The plain reference against the port's eager path at tiny sizes on the
CPU, in fp32, so that the check on the card measures the port and not a
wrong reference."""
from __future__ import annotations

import pytest
import torch

from perfbench import program
from perfbench import weights as W
from perfbench.modelspec import spec_of
from perfbench.reference import model as ref_model
from perfbench.reference import train as ref_train
from perfbench.tests.helpers import tiny_file

CPU = torch.device("cpu")
NAMES = ("qwen2-7b", "starcoder2-3b")


def _port(name: str, seed: int):
    m = spec_of(name, tiny_file(name))
    arch = program.arch_config(m, tiny_file(name))
    return m, arch, program.load_params(m, arch.model, seed, CPU)


@pytest.mark.parametrize("name", NAMES)
def test_forward_logits(name):
    m, arch, params = _port(name, 11)
    ids = W.tokens(11, "prompt", 0, (3, 40), m.vocab, CPU)
    with torch.no_grad():
        want = params({"tokens": ids})[..., :m.vocab]
    got = ref_model.served_logits(m, 11, ids, 0, block_rows=2)
    assert torch.allclose(got, want, rtol=1e-4, atol=1e-4), (got - want).abs().max()


@pytest.mark.parametrize("name", NAMES)
def test_loss_and_gradients(name):
    from repro_torch.models import transformer as tf

    m, arch, params = _port(name, 12)
    batch = W.train_batch(12, 0, 4, 24, m.vocab, CPU)
    names, leaves = zip(*params.named_parameters())
    loss = tf.loss_fn(params, batch, arch.model, remat="none")
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    ref = {k: v.requires_grad_(True) for k, v in ref_train.initial(m, 12, CPU).items()}
    ref_loss, ref_grads = ref_train.loss_and_grads(ref, batch, m, block_rows=3)
    assert ref_loss == pytest.approx(float(loss.detach()), rel=1e-5)
    for k, g in ref_grads.items():
        p = grads[k][:m.vocab] if k == "embedding" else grads[k]
        assert torch.allclose(g, p, rtol=1e-3, atol=1e-6), (k, (g - p).abs().max())


@pytest.mark.parametrize("int8", [False, True])
def test_adamw_as_the_port_updates(int8):
    """Two steps over leaves shaped as 8 stacked layers of one big leaf (a
    scale a layer) and one small one (a scale over all), and a leaf outside
    the layers."""
    from repro_torch.optim import AdamWConfig, apply_updates, init_state

    g = torch.Generator().manual_seed(3)
    shapes = {**{f"blocks.{i}.attn.wq": (1024, 1024) for i in range(8)},
              **{f"blocks.{i}.ln1.scale": (64,) for i in range(8)}, "embedding": (32, 16)}
    port = {k: torch.randn(s, generator=g) for k, s in shapes.items()}
    ref = {k: v.clone() for k, v in port.items()}
    t = tiny_file("starcoder2-3b")["train"]
    acfg = AdamWConfig(weight_decay=t["weight_decay"], int8_moments=int8)
    state = init_state(port, acfg)
    opt = ref_train.AdamW(ref, t, int8)
    assert len(opt.groups) == 8 + 1 + 1
    for step in range(2):
        grads = {k: torch.randn(s, generator=g) * (k.count("scale") + 0.01) for k, s in
                 shapes.items()}
        lr = ref_train.lr_at(100 + step, t)
        apply_updates(port, {k: v.clone() for k, v in grads.items()}, state, acfg,
                      torch.tensor(lr))
        opt.step(ref, grads, lr)
    for k in shapes:
        assert torch.allclose(port[k], ref[k], rtol=1e-6, atol=1e-7), k
        m = state["leaves"][k]["m"].float() * (state["leaves"][k]["m_scale"] if int8 else 1.0)
        assert torch.allclose(m, opt.moment_m(k), rtol=1e-5, atol=1e-9), k
        if int8:
            apart = (state["leaves"][k]["m"] != opt.m[k]).float().mean()
            assert apart < 1e-3, k  # codes apart only at rounding edges


def test_lr_schedule():
    from repro_torch.optim import warmup_cosine

    t = tiny_file("starcoder2-3b")["train"]
    for step in (0, 50, 100, 101, 5000, 10_000, 12_000):
        want = float(warmup_cosine(step, peak_lr=t["learning_rate"],
                                   warmup_steps=t["warmup_steps"], total_steps=t["total_steps"]))
        assert ref_train.lr_at(step, t) == pytest.approx(want, rel=1e-6)


def test_the_weights_are_the_seeds_alone():
    m = spec_of("qwen2-7b", tiny_file("qwen2-7b"))
    a, b = W.block(m, 1, 5, CPU), W.block(m, 1, 5, CPU)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["attn.wq"], W.block(m, 1, 6, CPU)["attn.wq"])
    assert not torch.equal(a["attn.wq"], W.block(m, 0, 5, CPU)["attn.wq"])
    assert W.seed_of(2**31 + 17, "layer", 3) != W.seed_of(2**31 + 18, "layer", 3)
