"""AdamW with fp32 master weights, optional int8-quantized moments, and
optional host-placed state (the UM PREFERRED_LOCATION(HOST) +
ACCESSED_BY(DEVICE) pattern — ZeRO-Offload).

The counterpart of ``repro.optim.adamw``: the reference's update, not
``torch.optim.AdamW`` (decay on the master of every leaf, norms and biases
included; ``m`` linear int8 and ``v`` stored as int8 of ``sqrt(v)``, with
absmax scales and round-half-to-even).  Parameters are a module's (or a
mapping name -> tensor), updated in place under ``torch.no_grad()``.

State layout, keyed by parameter name:
  {"step": 0-d int32,
   "leaves": {name: {"master", "m", "v"[, "m_scale", "v_scale"]}}}
  master: fp32 copy of the parameter (its own dtype unless master_dtype is
          "float32"); m, v: fp32, or int8 with 0-d fp32 scales.

The reference stacks the layers' parameters into leaves (L, ...) and picks
int8 scales per stacked leaf: one scale per layer when the leaf is big
(``_chunk_leading``: ndim >= 3, L >= 8, >= 2^20 elements a layer), else one
absmax over all L layers.  Here a block's parameter ``blocks.<i>.<path>`` is
layer i of the stacked leaf ``<path>``, so ``scale_groups`` applies the
same rule to the number of blocks: a big leaf gives each block its own
scale, any other shares one scale over the group of blocks (every block
holds the same value).  Big leaves are updated a block at a time, which
keeps the fp32 transients to one layer, as the reference's blocked update
does.

With the state in pinned host memory, ``launch/step.py`` fetches it to the
card for the update and offloads the updated state
(``core/streaming.py``).
"""
from __future__ import annotations

import dataclasses
import re

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    int8_moments: bool = False
    master_dtype: str = "float32"


# a stacked leaf with at least this many layers, and 2^20 elements a layer,
# keeps one int8 scale per layer
CHUNKED_UPDATE_MIN_LAYERS = 8

_BLOCK = re.compile(r"blocks\.(\d+)\.(.+)")


def _named_tensors(params) -> dict[str, torch.Tensor]:
    """``params`` (an ``nn.Module`` or a mapping name -> tensor) as a dict."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def scale_groups(named: dict[str, torch.Tensor]) -> list[list[str]]:
    """The parameter names in groups that share one int8 scale: the blocks'
    copies of one stacked leaf where the reference keeps one scale over its
    L layers, else each name alone."""
    stacked: dict[str, list[tuple[int, str]]] = {}
    groups = []
    for name in named:
        m = _BLOCK.fullmatch(name)
        if m is None:
            groups.append([name])
        else:
            stacked.setdefault(m.group(2), []).append((int(m.group(1)), name))
    for members in stacked.values():
        names = [n for _, n in sorted(members)]
        p = named[names[0]]
        per_layer = (p.ndim + 1 >= 3 and len(names) >= CHUNKED_UPDATE_MIN_LAYERS
                     and p.numel() >= 1 << 20)
        groups += [[n] for n in names] if per_layer else [names]
    return groups


def init_state(params, cfg: AdamWConfig) -> dict:
    """Fresh state on each parameter's device: the master a copy, the
    moments (and int8 scales) zero."""
    named = _named_tensors(params)
    mom = torch.int8 if cfg.int8_moments else torch.float32
    leaves = {}
    for name, p in named.items():
        master = p.detach().to(torch.float32 if cfg.master_dtype == "float32" else p.dtype,
                               copy=True)
        s = {"master": master, "m": torch.zeros(p.shape, dtype=mom, device=p.device),
             "v": torch.zeros(p.shape, dtype=mom, device=p.device)}
        if cfg.int8_moments:
            s["m_scale"] = torch.zeros((), dtype=torch.float32, device=p.device)
            s["v_scale"] = torch.zeros((), dtype=torch.float32, device=p.device)
        leaves[name] = s
    dev = next(iter(named.values())).device
    return {"step": torch.zeros((), dtype=torch.int32, device=dev), "leaves": leaves}


def _corrections(step: torch.Tensor, cfg: AdamWConfig, dtype: torch.dtype):
    """Adam's bias corrections 1 - b^step, in ``dtype`` (fp32 as in the
    reference; fp64 where the state is fp64)."""
    stepf = step.to(dtype)
    return 1.0 - cfg.b1 ** stepf, 1.0 - cfg.b2 ** stepf


def _dq(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return q.to(dtype) * scale.to(dtype)


def _quantize(xs: list[torch.Tensor]):
    """int8 absmax quantization of ``xs`` with one scale over all of them:
    (codes, scale)."""
    absmax = torch.stack([x.abs().amax() for x in xs]).amax()
    scale = torch.clamp(absmax, min=1e-12) / 127.0
    return [torch.round(x / scale).to(torch.int8) for x in xs], scale


def _moments(g, s, cfg: AdamWConfig, dtype):
    g = g.to(dtype)
    if cfg.int8_moments:
        # m linear int8; v stored as sqrt(v) int8 (range compression —
        # linear int8 on v collapses small second moments to zero)
        m = _dq(s["m"], s["m_scale"], dtype)
        v = torch.square(_dq(s["v"], s["v_scale"], dtype))
    else:
        m, v = s["m"].to(dtype), s["v"].to(dtype)
    m = cfg.b1 * m + (1 - cfg.b1) * g
    v = cfg.b2 * v + (1 - cfg.b2) * g * g
    return m, v


def _step_master(p, s, m, v, cfg: AdamWConfig, lr, b1c, b2c) -> None:
    mhat = m / b1c
    vhat = v / b2c
    master = s["master"].to(m.dtype)
    update = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * master
    master = master - lr * update
    s["master"].copy_(master)
    p.copy_(master)


@torch.no_grad()
def apply_updates(params, grads, state: dict, cfg: AdamWConfig, lr):
    """One AdamW step: writes the parameters and ``state`` in place and
    returns them.  ``grads`` maps each parameter's name to its gradient;
    ``lr`` is a number or a 0-d tensor.  The arithmetic is fp32 (fp64 where
    the state's masters are fp64), whatever the gradients' dtype."""
    named = _named_tensors(params)
    if set(grads) != set(named):
        raise ValueError(f"apply_updates: gradients for {sorted(set(grads) ^ set(named))} "
                         "do not match the parameters")
    step = state["step"] + 1
    leaves = state["leaves"]
    corrections = {}
    for group in scale_groups(named):
        dtype = torch.promote_types(leaves[group[0]]["master"].dtype, torch.float32)
        if dtype not in corrections:
            corrections[dtype] = _corrections(step, cfg, dtype)
        b1c, b2c = corrections[dtype]
        new = [_moments(grads[n], leaves[n], cfg, dtype) for n in group]
        for n, (m, v) in zip(group, new):
            _step_master(named[n], leaves[n], m, v, cfg, lr, b1c, b2c)
        if cfg.int8_moments:
            mq, m_scale = _quantize([m for m, _ in new])
            vq, v_scale = _quantize([torch.sqrt(v) for _, v in new])
            for i, n in enumerate(group):
                s = leaves[n]
                s["m"].copy_(mq[i])
                s["v"].copy_(vq[i])
                s["m_scale"].copy_(m_scale)
                s["v_scale"].copy_(v_scale)
        else:
            for n, (m, v) in zip(group, new):
                leaves[n]["m"].copy_(m)
                leaves[n]["v"].copy_(v)
        del new
    state["step"].copy_(step)
    return params, state


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every tensor of ``tree`` (a mapping or
    an iterable of tensors), in fp32."""
    leaves = tree.values() if isinstance(tree, dict) else tree
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32))) for x in leaves))


@torch.no_grad()
def clip_by_global_norm(grads: dict, max_norm: float):
    """Scales ``grads`` (name -> tensor) in place by min(1, max_norm /
    norm), each in fp32 and back to its dtype; returns (grads, norm)."""
    norm = global_norm(grads)
    # built on the norm's device, not copied from the host: a CUDA graph
    # captures the step
    limit = torch.full((), max_norm, dtype=torch.float32, device=norm.device)
    scale = torch.clamp(limit / torch.clamp(norm, min=1e-12), max=1.0)
    for g in grads.values():
        g.copy_(g.to(torch.float32) * scale)
    return grads, norm
