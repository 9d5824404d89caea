"""The system under test, set up from a configuration file: the port's
config of the same model with the file's sizes and the fields its form
sets, and the seed's weights copied into the port's own ``Transformer``."""
from __future__ import annotations

import dataclasses

import torch

from perfbench import weights as W
from perfbench.modelspec import ModelSpec, form_of


def port_model(m: ModelSpec, model):
    """The port's ``ModelConfig`` ``model`` with the file's depth and the
    fields ``m``'s form sets."""
    return dataclasses.replace(model, num_layers=m.layers, **form_of(m).port_fields(m))


def arch_config(m: ModelSpec, file: dict):
    """The port's ``ArchConfig`` of ``m.arch`` with the file's sizes, form
    and (with a ``train`` group) its training hyper-parameters."""
    from repro_torch.configs import get_config
    from repro_torch.optim import AdamWConfig

    arch = get_config(m.arch)
    arch = dataclasses.replace(arch, model=port_model(m, arch.model))
    t = file.get("train")
    if t is not None:
        adam = AdamWConfig()
        if (adam.b1, adam.b2, adam.eps) != (t["adam_b1"], t["adam_b2"], t["adam_eps"]):
            raise ValueError(f"the port's AdamW has b1, b2, eps {adam.b1, adam.b2, adam.eps}; "
                             f"the file states {t['adam_b1'], t['adam_b2'], t['adam_eps']}")
        arch = dataclasses.replace(arch, train=dataclasses.replace(
            arch.train, learning_rate=t["learning_rate"], weight_decay=t["weight_decay"],
            warmup_steps=t["warmup_steps"], grad_clip=t["grad_clip"], microbatches=1,
            remat=t["remat"], master_dtype="float32"))
    return arch


def serve_config_matches(m: ModelSpec, arch) -> None:
    """``launch.serve.serve`` builds the port's own config from the arch's
    name (with the depth of the weights it is given): it has to be the
    file's, or the cell would serve another model than it states."""
    from repro_torch.configs import get_config

    own = dataclasses.replace(get_config(m.arch).model, num_layers=arch.model.num_layers)
    if own != arch.model:
        diff = {f.name: (getattr(own, f.name), getattr(arch.model, f.name))
                for f in dataclasses.fields(own)
                if getattr(own, f.name) != getattr(arch.model, f.name)}
        raise ValueError(f"serve() runs the port's {m.arch} config, which differs from the "
                         f"file in (port, file): {diff}")


def param_names(m: ModelSpec) -> list[str]:
    form = form_of(m)
    names = [f"blocks.{i}.{k}" for i in range(m.layers) for k in form.block_shapes(m)]
    return names + list(form.top_shapes(m))


@torch.no_grad()
def load_params(m: ModelSpec, cfg, seed: int, device):
    """The port's ``Transformer`` for ``cfg``, left uninitialised, filled
    with the seed's weights a layer at a time (rows of the padded
    vocabulary past ``vocab`` zero)."""
    from repro_torch.models.transformer import Transformer

    params = Transformer(cfg, device)
    named = dict(params.named_parameters())
    if set(named) != set(param_names(m)):
        raise ValueError(f"the port's parameters {sorted(set(named) ^ set(param_names(m)))} "
                         "differ from the reference's")

    def fill(prefix: str, made: dict) -> None:
        dst, src = [], []
        for k, v in made.items():
            p = named[prefix + k]
            if p.shape != v.shape:
                if p.shape[1:] != v.shape[1:] or p.shape[0] < v.shape[0]:
                    raise ValueError(f"{prefix + k}: the port's {tuple(p.shape)}, the "
                                     f"reference's {tuple(v.shape)}")
                p[v.shape[0]:].zero_()
                p = p[:v.shape[0]]
            dst.append(p)
            src.append(v)
        torch._foreach_copy_(dst, src)

    for i in range(m.layers):
        fill(f"blocks.{i}.", W.block(m, i, seed, device))
    fill("", W.top(m, seed, device))
    return params
