"""Step builders: the counterparts of ``repro.launch.step.build_train_step``,
``build_prefill_step`` and ``build_serve_step`` (greedy argmax), for every
family.

The ResidencyPlan threads through the train step: remat policy, int8
moments, and the optimizer state's placement (pinned host memory, fetched
to the card for the update and offloaded after it).  The reference's
ZeRO-1 / FSDP gradient sharding constraints are hints to its mesh; they
wait for the port's mesh slice.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.advise import MemorySpace
from repro_torch.core.residency import ResidencyPlan
from repro_torch.core.streaming import fetch_params, offload_params
from repro_torch.device import resolve
from repro_torch.models import transformer as tf
from repro_torch.optim import AdamWConfig, apply_updates, clip_by_global_norm, warmup_cosine


def _adamw_cfg(arch: ArchConfig, plan: ResidencyPlan | None) -> AdamWConfig:
    int8 = plan.int8_moments if plan is not None else arch.train.int8_moments
    return AdamWConfig(
        weight_decay=arch.train.weight_decay,
        int8_moments=int8,
        master_dtype=arch.train.master_dtype,
    )


def build_train_step(arch: ArchConfig, shape: ShapeConfig, mesh=None,
                     plan: ResidencyPlan | None = None, *, total_steps: int = 10_000,
                     device=None):
    """Returns train_step(params, opt_state, batch, step) -> (params,
    opt_state, metrics) for a ``Transformer`` and a state of
    ``optim.init_state`` on ``device`` (default: the card; raises without
    one).  The parameters are updated in place; with the plan's optimizer
    on the host, ``opt_state`` comes in and goes out in pinned memory.

    Gradients: with one microbatch in the parameters' dtype, as the
    reference's; with ``microbatches`` > 1 summed over the microbatches in
    fp32 buffers and divided by their number.  Metrics: ``loss``,
    ``grad_norm`` (before clipping) and ``lr``, as 0-d tensors.
    """
    if mesh is not None:
        raise NotImplementedError("build_train_step: the port has no device mesh yet")
    cfg = arch.model
    dev = resolve(device)
    acfg = _adamw_cfg(arch, plan)
    remat = plan.remat if plan is not None else arch.train.remat
    micro = max(1, min(arch.train.microbatches, shape.global_batch))
    opt_on_host = plan is not None and plan.opt_space is MemorySpace.HOST

    def grads_of(params, leaves, mb):
        loss = tf.loss_fn(params, mb, cfg, remat=remat)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    def train_step(params, opt_state, batch, step):
        lr = warmup_cosine(step, peak_lr=arch.train.learning_rate,
                           warmup_steps=arch.train.warmup_steps,
                           total_steps=total_steps)
        names, leaves = zip(*params.named_parameters())
        if micro == 1:
            loss, grads = grads_of(params, leaves, batch)
        else:
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]
            loss = 0.0
            for i in range(micro):
                mb = {k: v.reshape((micro, v.shape[0] // micro) + v.shape[1:])[i]
                      for k, v in batch.items()}
                l, g = grads_of(params, leaves, mb)
                for a, x in zip(acc, g):
                    a += x
                loss = loss + l
                del g
            grads = [a / micro for a in acc]
            del acc
            loss = loss / micro
        grads, gnorm = clip_by_global_norm(dict(zip(names, grads)), arch.train.grad_clip)
        if opt_on_host:
            opt_state = fetch_params(opt_state, dev)       # host -> card
        params, opt_state = apply_updates(params, grads, opt_state, acfg, lr)
        if opt_on_host:
            opt_state = offload_params(opt_state, dev)     # card -> host
        return params, opt_state, {"loss": loss, "grad_norm": gnorm, "lr": lr}

    return train_step


def build_prefill_step(arch: ArchConfig):
    cfg = arch.model

    def prefill_step(params, batch):
        logits, caches = tf.prefill(params, batch, cfg)
        return logits.argmax(dim=-1), caches

    return prefill_step


def build_serve_step(arch: ArchConfig):
    """One-token decode step: greedy sample + cache update (in place)."""
    cfg = arch.model

    def serve_step(params, batch, caches, cache_len):
        logits, caches = tf.decode_step(params, batch, caches, cache_len, cfg)
        return logits.argmax(dim=-1), caches

    return serve_step
