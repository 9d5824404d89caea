"""Sharding rules: parameter / batch / cache specs for every arch, and their
DTensor placements.

The counterpart of ``repro.launch.sharding`` (strategy in DESIGN.md §6):
TP over "model" (attention heads, FFN hidden, vocab, expert hidden), FSDP
over "data" (the non-TP matrix dim of every large parameter), pure DP over
"pod", and sequence-sharded decode caches over "model".

A spec is a tuple like ``PartitionSpec`` (``models.common``): one entry
per tensor dim, each None, an axis name or a tuple of names.  The rules
are keyed on the parameter's path: the port's ``blocks.<i>.tm.w_r`` is
``tm/w_r`` to the rules, and a block's tensor has no leading L dim, so its
spec is the reference's with the stacked ``None`` dropped.
"""
from __future__ import annotations

import re

from torch import nn
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import axis_sizes
from repro_torch.models.common import get_param_mode, get_sharding_mode, spec_placements

_BLOCK = re.compile(r"blocks\.(\d+)\.(.+)")


def _param_rule(path: str, ndim: int, cfg: ModelConfig) -> tuple:
    """Spec for a *single layer's* parameter (no leading L dim)."""
    d, m = "data", "model"
    # --- embeddings / heads: vocab over model (TP), d over data (FSDP)
    if path.endswith("embedding") or path.endswith("lm_head"):
        return (None, m, d) if ndim == 3 else (m, d)
    # --- norms & small vectors replicate
    if "ln" in path or "norm" in path or path.endswith(("scale", "bias")):
        return ()
    if ndim == 1:
        # per-channel vectors (mus, D, dt_bias, biases): shard the channel
        # over model when it is a hidden-projection output, else replicate
        if path.endswith(("bq", "bk", "bv")):
            return (m,)
        if path.endswith(("conv_b", "dt_bias", "D", "u")):
            return (m,) if "mamba" in path else ()
        return ()
    # --- attention
    if path.endswith(("wq", "wk", "wv")):
        return (d, m)
    if path.endswith("wo"):
        return (m, d)
    # --- dense mlp
    if path.endswith(("w_gate", "w_up")) and "moe" not in path:
        return (d, m)
    if path.endswith("w_down") and "moe" not in path:
        return (m, d)
    # --- moe: experts replicated on the E dim (E < model size), TP inside
    if path.endswith("router"):
        return (d, None)
    if "moe" in path and ndim == 3:
        if path.endswith(("w_gate", "w_up")):
            return (None, d, m)
        return (None, m, d)  # w_down
    # --- rwkv time/channel mix
    if path.endswith(("tm/w_r", "tm/w_k", "tm/w_v", "tm/w_g")):
        return (d, m)
    if path.endswith("tm/w_o"):
        return (m, d)
    if path.endswith(("cm/w_k", "cm/w_r")):
        return (d, m)
    if path.endswith("cm/w_v"):
        return (m, d)
    if path.endswith(("decay_A", "decay_B")):
        return ()  # tiny lora
    if path.endswith("u") and ndim == 2:
        return ()  # (H, N) bonus
    # --- mamba
    if path.endswith("in_proj"):
        return (d, m)
    if path.endswith("out_proj"):
        return (m, d)
    if path.endswith(("w_dt",)):
        return (m, None)
    if path.endswith(("w_B", "w_C", "A_log")):
        return (m, None)
    if path.endswith("conv_w"):
        return (None, m)
    # fallback: shard the largest dim over model
    return tuple(m if i == ndim - 1 else None for i in range(ndim))


def _path_str(name: str) -> tuple[str, bool]:
    """A parameter's name as the rules' path, and whether it is a block's:
    ``blocks.3.tm.w_r`` -> ("tm/w_r", True)."""
    m = _BLOCK.fullmatch(name)
    if m is None:
        return name.replace(".", "/"), False
    return m.group(2).replace(".", "/"), True


def _param_rule_fsdp(shape, mesh_total: int) -> tuple:
    """Pure-FSDP: shard the largest evenly-divisible dim over (data, model)
    jointly; replicate vectors/scalars (ZeRO-3 over the full mesh)."""
    if len(shape) < 2:
        return (None,) * len(shape)
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in order:
        if shape[i] % mesh_total == 0:
            return tuple(("data", "model") if j == i else None for j in range(len(shape)))
    return (None,) * len(shape)


def _spec(*entries) -> tuple:
    """A spec as ``PartitionSpec`` normalises it: a one-name tuple is the
    name, an empty one None."""
    return tuple((e[0] if len(e) == 1 else e or None) if isinstance(e, tuple) else e
                 for e in entries)


def _strip_data(spec: tuple) -> tuple:
    """ZeRO-1 param storage: drop the FSDP ("data") component — params are
    TP-sharded only and live gathered; optimizer state keeps the data shard
    and the post-update all-gather happens once per step."""
    out = []
    for e in spec:
        if e == "data":
            out.append(None)
        elif isinstance(e, tuple):
            kept = tuple(a for a in e if a != "data")
            out.append(kept if kept else None)
        else:
            out.append(e)
    return _spec(*out)


def _named_shapes(params) -> dict[str, tuple[int, ...]]:
    """{name: shape} of a module's parameters or of a mapping name -> tensor."""
    items = params.named_parameters() if isinstance(params, nn.Module) else params.items()
    return {n: tuple(p.shape) for n, p in items}


def param_specs(cfg: ModelConfig, params, mode: str | None = None) -> dict[str, tuple]:
    """{parameter name: spec} for a ``Transformer`` (or a mapping name ->
    tensor) under ``mode`` (default: the current param mode)."""
    mode = mode or get_param_mode()
    out = {}
    for name, shape in _named_shapes(params).items():
        path, _ = _path_str(name)
        if mode == "fsdp":
            out[name] = _param_rule_fsdp(shape, 256)
            continue
        spec = _param_rule(path, len(shape), cfg)
        out[name] = _strip_data(spec) if mode == "zero1" else spec
    return out


def opt_specs(cfg: ModelConfig, params, mode: str | None = None) -> dict[str, tuple]:
    """Optimizer-state spec per param: under zero1 this re-adds a "data"
    shard on the first large dim the param spec leaves unsharded.

    The reference's block leaves are stacked (L, ...), and it may pick the
    L dim (L a multiple of 16); a block's tensor has no L dim, so there its
    state keeps the param spec, which is the reference's spec with L
    dropped."""
    mode = mode or get_param_mode()
    pspecs = param_specs(cfg, params, mode)
    if mode != "zero1":
        return pspecs
    shapes = _named_shapes(params)
    layers = 1 + max((int(m.group(1)) for m in map(_BLOCK.fullmatch, shapes) if m),
                     default=-1)
    out = {}
    for name, shape in shapes.items():
        spec = pspecs[name]
        used = {a for e in spec for a in (e if isinstance(e, tuple) else (e,)) if a}
        if "data" in used:
            out[name] = spec
            continue
        lead = 1 if _path_str(name)[1] else 0     # the reference's stacked L
        full_shape = (layers,) * lead + shape
        entries = [None] * lead + list(spec)
        entries += [None] * (len(full_shape) - len(entries))
        for i, e in enumerate(entries):
            if e is None and full_shape[i] % 16 == 0 and full_shape[i] >= 16:
                entries[i] = "data"
                out[name] = tuple(entries[lead:])
                break
        else:
            out[name] = spec
    return out


def param_shardings(cfg: ModelConfig, params, mesh) -> dict[str, list]:
    return {n: spec_placements(s, mesh) for n, s in param_specs(cfg, params).items()}


def distribute_module(module: nn.Module, specs: dict[str, tuple], mesh) -> nn.Module:
    """Replace each parameter of ``module`` by a DTensor placed by its spec
    (in place; returns the module)."""
    for name, spec in specs.items():
        *path, leaf = name.split(".")
        owner = module.get_submodule(".".join(path)) if path else module
        p = getattr(owner, leaf)
        local = p.to_local() if isinstance(p, DTensor) else p
        d = distribute_tensor(local.detach(), mesh, spec_placements(spec, mesh))
        setattr(owner, leaf, nn.Parameter(d, requires_grad=p.requires_grad))
    return module


def distribute_tree(tree: dict, specs: dict, mesh) -> dict:
    """{key: tensor} placed by ``specs[key]`` (a spec, or None to replicate)."""
    return {k: distribute_tensor(v, mesh, spec_placements(specs.get(k) or (), mesh))
            for k, v in tree.items()}


def distribute_opt_state(state: dict, cfg: ModelConfig, params, mesh,
                         mode: str | None = None) -> dict:
    """An ``optim.init_state`` state placed on ``mesh``: masters and
    moments by ``opt_specs``, the 0-d scales and step replicated."""
    ospecs = opt_specs(cfg, params, mode)
    leaves = {}
    for name, s in state["leaves"].items():
        leaves[name] = {k: distribute_tensor(v, mesh, spec_placements(
            ospecs[name] if v.ndim else (), mesh)) for k, v in s.items()}
    return {"step": state["step"], "leaves": leaves}


# ---------------------------------------------------------------------------
# Batches and caches
# ---------------------------------------------------------------------------

def _dp(mesh) -> tuple[str, ...] | str:
    names = axis_sizes(mesh)
    if get_sharding_mode() == "fsdp":
        return tuple(a for a in ("pod", "data", "model") if a in names)
    return ("pod", "data") if "pod" in names else "data"


def _axes_size(mesh, axes) -> int:
    sizes = axis_sizes(mesh)
    size = 1
    for a in (axes if isinstance(axes, tuple) else (axes,)):
        size *= sizes[a]
    return size


def batch_specs(cfg: ModelConfig, mesh, kind: str, global_batch: int | None = None) -> dict:
    """Specs for input batches (see launch/step.py input_specs)."""
    dp = _dp(mesh)
    # drop axes (pod first) until the batch divides; unsharded as last resort
    while (isinstance(dp, tuple) and dp and global_batch is not None
           and global_batch % max(_axes_size(mesh, dp), 1) != 0):
        dp = dp[1:] or None
    if (global_batch is not None and dp is not None
            and global_batch % max(_axes_size(mesh, dp), 1) != 0):
        dp = None  # tiny batches (long_500k B=1) stay unsharded
    if kind in ("train", "prefill"):
        specs = {}
        if cfg.frontend in ("audio",) and cfg.num_codebooks > 1:
            specs["tokens"] = _spec(dp, None, None)
            specs["labels"] = _spec(dp, None, None)
        elif cfg.frontend == "vision":
            specs["embeds"] = _spec(dp, None, None)
            specs["labels"] = _spec(dp, None)
            specs["positions_thw"] = _spec(dp, None, None)
        else:
            specs["tokens"] = _spec(dp, None)
            specs["labels"] = _spec(dp, None)
        if kind == "prefill":
            specs.pop("labels", None)
        return specs
    # decode: one token per sequence
    if cfg.family == "audio":
        return {"tokens": _spec(dp, None)}
    return {"tokens": _spec(dp)}


def cache_specs(cfg: ModelConfig, mesh, batch: int) -> dict:
    """Decode-cache specs: sequence (or state channel) sharded over model."""
    dp = _dp(mesh)
    dp_size = _axes_size(mesh, dp)
    bspec = _spec(dp)[0] if batch % max(dp_size, 1) == 0 and batch >= dp_size else None
    if cfg.family == "ssm":
        return {
            "tm_shift": (None, bspec, "model"),
            "cm_shift": (None, bspec, "model"),
            "wkv": (None, bspec, None, "model", None),  # key dim N over model
        }
    specs = {
        "k": (None, bspec, "model", None, None),   # SP: seq over model
        "v": (None, bspec, "model", None, None),
    }
    if cfg.family == "hybrid":
        specs["conv"] = (None, bspec, None, "model")     # d_inner over model
        specs["ssm"] = (None, bspec, "model", None)
    return specs


__all__ = [
    "batch_specs", "cache_specs", "distribute_module", "distribute_opt_state",
    "distribute_tree", "opt_specs", "param_shardings", "param_specs",
]
