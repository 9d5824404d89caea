"""Training in the reference: the next-token loss and its gradients, the
global-norm clip, the warmup-cosine lr and AdamW with fp32 masters and fp32
or int8 moments, in plain PyTorch and fp32.

AdamW as the configured training states it: decoupled decay on every
leaf, bias corrections 1 - b^t, ``update = m^ / (sqrt(v^) + eps) + wd w``.
Int8 moments: ``m`` as linear int8 and ``v`` as int8 of ``sqrt(v)``, each
with an absmax / 127 scale and round-half-to-even; one scale for each
layer of a stacked leaf of at least 8 layers and 2^20 elements a layer,
one scale over all the layers of any other stacked leaf, one for each leaf
outside the layers.  The new moments are computed from the stored ones in
fp32 and the update uses them before they are stored.

The gradient of a step is summed over blocks of ``block_rows`` rows, each
layer recomputed in the backward pass, so that it fits on the card once
the program's state is gone.
"""
from __future__ import annotations

import functools
import math
import re

import torch
from torch.utils.checkpoint import checkpoint

from perfbench import weights as W
from perfbench.modelspec import ModelSpec, form_of
from perfbench.reference.model import fp32
from perfbench.reference.precision import FP32

PER_LAYER_MIN_LAYERS = 8
PER_LAYER_MIN_ELEMENTS = 1 << 20
_BLOCK = re.compile(r"blocks\.(\d+)\.(.+)")


def lr_at(step: int, t: dict) -> float:
    """Linear warmup to the peak, then cosine decay to a tenth of it, in fp32."""
    s = torch.tensor(float(step), dtype=torch.float32)
    peak, warm, total = t["learning_rate"], t["warmup_steps"], t["total_steps"]
    if s < warm:
        return float(peak * s / max(warm, 1))
    prog = torch.clamp((s - warm) / max(total - warm, 1), 0.0, 1.0)
    return float(peak * (0.1 + 0.9 * 0.5 * (1 + torch.cos(math.pi * prog))))


def initial(m: ModelSpec, seed: int, device) -> dict[str, torch.Tensor]:
    """Every parameter at the start, fp32, by the port's names."""
    out = {}
    for i in range(m.layers):
        out.update({f"blocks.{i}.{k}": v for k, v in fp32(W.block(m, i, seed, device)).items()})
    out.update(fp32(W.top(m, seed, device)))
    return out


def loss_sum(params: dict, tokens, labels, m: ModelSpec, mm=FP32):
    """The summed next-token NLL of the rows, each of the form's layers
    checkpointed."""
    form = form_of(m)
    x = params["embedding"][tokens.long()]
    for i in range(m.layers):
        p = {k[len(f"blocks.{i}."):]: v for k, v in params.items() if k.startswith(f"blocks.{i}.")}
        x = checkpoint(functools.partial(form.layer, p, m=m, mm=mm), x, use_reentrant=False)
    logits = form.head(x, params, m, mm)
    nll = torch.logsumexp(logits, -1) - logits.gather(-1, labels.long()[..., None])[..., 0]
    return nll.sum()


def loss_and_grads(params: dict, batch: dict, m: ModelSpec, mm=FP32, block_rows: int = 2):
    """(mean loss, {name: gradient}) over the batch, summed a block of rows
    at a time."""
    for p in params.values():
        p.grad = None
    n = batch["labels"].numel()
    total = 0.0
    for r in range(0, batch["tokens"].shape[0], block_rows):
        part = loss_sum(params, batch["tokens"][r:r + block_rows],
                        batch["labels"][r:r + block_rows], m, mm) / n
        part.backward()
        total += float(part.detach())
    return total, {k: p.grad for k, p in params.items()}


def scale_groups(names: list[str], shapes: dict) -> list[list[str]]:
    """The names that share one int8 scale (see the module's docstring)."""
    stacked: dict[str, list[tuple[int, str]]] = {}
    groups = []
    for n in names:
        hit = _BLOCK.fullmatch(n)
        if hit is None:
            groups.append([n])
        else:
            stacked.setdefault(hit.group(2), []).append((int(hit.group(1)), n))
    for members in stacked.values():
        ordered = [n for _, n in sorted(members)]
        shape = shapes[ordered[0]]
        per_layer = (len(shape) + 1 >= 3 and len(ordered) >= PER_LAYER_MIN_LAYERS
                     and math.prod(shape) >= PER_LAYER_MIN_ELEMENTS)
        groups += [[n] for n in ordered] if per_layer else [ordered]
    return groups


class AdamW:
    """The optimizer over ``params`` (fp32 leaves that are the masters)."""

    def __init__(self, params: dict, t: dict, int8: bool):
        self.t, self.int8, self.count = t, int8, 0
        dtype = torch.int8 if int8 else torch.float32
        self.m = {k: torch.zeros(p.shape, dtype=dtype, device=p.device) for k, p in params.items()}
        self.v = {k: torch.zeros_like(x) for k, x in self.m.items()}
        self.scales = {}  # name -> (m scale, v scale) with int8
        self.groups = scale_groups(list(params), {k: tuple(p.shape) for k, p in params.items()})

    def moment_m(self, name: str) -> torch.Tensor:
        """The first moment as stored, in fp32."""
        if self.int8:
            return self.m[name].to(torch.float32) * self.scales.get(name, (0.0, 0.0))[0]
        return self.m[name]

    def moment_v(self, name: str) -> torch.Tensor:
        if self.int8:
            return (self.v[name].to(torch.float32) * self.scales.get(name, (0.0, 0.0))[1]).square()
        return self.v[name]

    @torch.no_grad()
    def step(self, params: dict, grads: dict, lr: float) -> None:
        t = self.t
        self.count += 1
        c = torch.tensor(float(self.count), dtype=torch.float32)
        b1c = float(1.0 - t["adam_b1"] ** c)
        b2c = float(1.0 - t["adam_b2"] ** c)
        for group in self.groups:
            new = {}
            for n in group:
                g = grads[n].to(torch.float32)
                mo = t["adam_b1"] * self.moment_m(n) + (1 - t["adam_b1"]) * g
                vo = t["adam_b2"] * self.moment_v(n) + (1 - t["adam_b2"]) * g * g
                w = params[n]
                update = (mo / b1c) / (torch.sqrt(vo / b2c) + t["adam_eps"]) + t["weight_decay"] * w
                w.sub_(lr * update)
                new[n] = (mo, vo)
            if self.int8:
                ms = _scale([mo for mo, _ in new.values()])
                vs = _scale([torch.sqrt(vo) for _, vo in new.values()])
                for n, (mo, vo) in new.items():
                    self.m[n] = torch.round(mo / ms).to(torch.int8)
                    self.v[n] = torch.round(torch.sqrt(vo) / vs).to(torch.int8)
                    self.scales[n] = (ms, vs)
            else:
                for n, (mo, vo) in new.items():
                    self.m[n], self.v[n] = mo, vo


def _scale(xs: list[torch.Tensor]) -> torch.Tensor:
    return torch.stack([x.abs().amax() for x in xs]).amax().clamp_min(1e-12) / 127.0


def clip(grads: dict, limit: float) -> None:
    """Scales the gradients in place by min(1, limit / global norm)."""
    norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
    scale = torch.clamp(limit / norm.clamp_min(1e-12), max=1.0)
    for g in grads.values():
        g.mul_(scale)


def run(m: ModelSpec, t: dict, seed: int, batch_of, steps: int, first_step: int,
        int8: bool, device, mm=FP32, block_rows: int = 2) -> dict:
    """``steps`` training steps from the seed's weights on ``batch_of(i)``:
    the losses, the first gradient's norm a leaf as the optimizer's state
    holds it after step 1 (m / (1 - b1)), and each leaf's change after the
    last step."""
    params = {k: v.requires_grad_(True) for k, v in initial(m, seed, device).items()}
    opt = AdamW(params, t, int8)
    losses, grad_norms = [], None
    for i in range(steps):
        loss, grads = loss_and_grads(params, batch_of(i), m, mm, block_rows)
        losses.append(loss)
        clip(grads, t["grad_clip"])
        opt.step({k: p.data for k, p in params.items()}, grads, lr_at(first_step + i, t))
        if i == 0:
            grad_norms = {k: float(torch.linalg.vector_norm(opt.moment_m(k))) / (1 - t["adam_b1"])
                          for k in params}
        del grads
    for p in params.values():
        p.grad = None
    start = initial_norm_gap(m, seed, {k: p.detach() for k, p in params.items()}, device)
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": start}


@torch.no_grad()
def initial_norm_gap(m: ModelSpec, seed: int, now: dict, dev) -> dict[str, float]:
    """||now - start|| for every leaf, the start made again from the seed on
    ``dev`` a layer at a time (``now``'s leaves moved there one by one)."""
    out = {}
    for i in range(m.layers):
        for k, v in fp32(W.block(m, i, seed, dev)).items():
            name = f"blocks.{i}.{k}"
            out[name] = _gap(now[name], v)
    for k, v in fp32(W.top(m, seed, dev)).items():
        out[k] = _gap(now[k], v)
    return {k: float(x) for k, x in zip(out, torch.stack(list(out.values())).tolist())}


def _gap(now: torch.Tensor, start: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(now.to(start.device, torch.float32) - start)
