"""Shared by the port's train-step tests: one ``build_train_step`` step of
reduced starcoder2-3b in fp32 from JAX's weights against JAX's jitted step
(``check_train_step``), and the helpers that build both sides' configs."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.configs.base import MeshConfig as JMesh
from repro.configs.base import ShapeConfig as JShape
from repro.core import residency as jres
from repro.core.advise import MemorySpace as JSpace
from repro.launch import step as jstep
from repro.models import transformer as jt
from repro.optim import adamw as jadamw
from repro_torch import configs as tconfigs
from repro_torch.core import residency as tres
from repro_torch.core.advise import MemorySpace as TSpace
from repro_torch.interop import opt_state_from_jax, params_from_jax
from repro_torch.launch import step as tstep

STEP_TOL = 1e-5
TINY_GRAD = 1e-6  # 100 x Adam's eps
STEP_CASES = ("fp32", "micro2", "host_int8")
STEP = 5  # past a warmup of 2


def np64(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().double().numpy()
    return np.asarray(a, np.float64)


def archs(arch_name, **train_kw):
    """The reduced arch on both sides, with train settings replaced."""
    out = []
    for mod in (jconfigs, tconfigs):
        a = mod.get_config(arch_name)
        out.append(dataclasses.replace(a, model=a.model.reduce(),
                                       train=dataclasses.replace(a.train, **train_kw)))
    return out


def plans(jarch, tarch, **kw):
    return (jres.ResidencyPlan(jarch.name, "t", JMesh(), jres.MemoryBudget(),
                               **{k: (JSpace.HOST if v is TSpace.HOST else v)
                                  for k, v in kw.items()}),
            tres.ResidencyPlan(tarch.name, "t", tconfigs.MeshConfig(), tres.MemoryBudget(),
                               **kw))


def check_train_step(case: str, tensor_step: bool) -> None:
    """One ``build_train_step`` step (``STEP``, as an int or as a 0-d int32
    tensor) on reduced starcoder2-3b in fp32 from JAX's weights: loss, grad
    norm, lr, parameters and state against JAX's jitted step within
    ``STEP_TOL``; ``micro2`` against JAX's fp32-accumulating scan over 2
    microbatches; ``host_int8`` with a plan that puts int8 moments on the
    host (the identity on the CPU)."""
    jarch, tarch = archs("starcoder2-3b", warmup_steps=2, learning_rate=3e-3,
                         microbatches=2 if case == "micro2" else 1)
    jplan, tplan = (plans(jarch, tarch, opt_space=TSpace.HOST, int8_moments=True)
                    if case == "host_int8" else (None, None))
    cfg = jarch.model
    B, S = 4, 32
    jtree = jax.jit(lambda k: jt.init_params(k, cfg))(jax.random.key(2))
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, axis=1)}
    jstate = jadamw.init_state(jtree, jstep._adamw_cfg(jarch, jplan))
    model = params_from_jax(jtree, cfg, "cpu")
    tstate = opt_state_from_jax(jstate, model)
    jtree0 = jtree

    def jgrad(tree, b):
        return jax.jit(jax.grad(lambda p: jt.loss_fn(p, jax.tree.map(jnp.asarray, b), cfg)))(tree)

    jfn = jax.jit(jstep.build_train_step(jarch, JShape("t", S, B, "train"), None, jplan,
                                         total_steps=10))
    jtree, jstate, jm = jfn(jtree, jstate, jax.tree.map(jnp.asarray, batch), jnp.int32(STEP))
    tfn = tstep.build_train_step(tarch, tconfigs.ShapeConfig("t", S, B, "train"), None,
                                 tplan, total_steps=10, device="cpu")
    step = torch.tensor(STEP, dtype=torch.int32) if tensor_step else STEP
    _, tstate, tm = tfn(model, tstate, {k: torch.from_numpy(v) for k, v in batch.items()},
                        step)
    for k in ("loss", "grad_norm", "lr"):
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=STEP_TOL), k
    # Adam moves a weight by about lr whatever its gradient's size; where
    # the gradient is near eps (1e-8), that move follows the gradient's
    # rounding, so those weights are held to the step's size instead
    grads = dict(params_from_jax(jgrad(jtree0, batch), cfg, "cpu").named_parameters())
    lr = float(jm["lr"])
    ref = opt_state_from_jax(jstate, model)
    assert int(tstate["step"]) == int(ref["step"]) == 1
    params = dict(model.named_parameters())
    for n, s in tstate["leaves"].items():
        g = np64(grads[n])
        tiny = (np.abs(g) < TINY_GRAD) & (g != 0)  # zero: the padded vocab rows
        assert tiny.mean() < 1e-2, n
        for k, x in [("param", params[n])] + sorted(s.items()):
            if x.dtype == torch.int8:
                continue
            got, want = np64(x), np64(ref["leaves"][n]["master" if k == "param" else k])
            if k in ("param", "master"):
                assert np.all(np.abs(got[tiny] - want[tiny]) <= 2 * lr), (n, k)
                got, want = got[~tiny], want[~tiny]
            np.testing.assert_allclose(got, want, rtol=STEP_TOL, atol=STEP_TOL,
                                       err_msg=f"{n} {k}")
