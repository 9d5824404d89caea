"""Carry arrays across from NumPy (and from JAX, through ``np.asarray``)
into torch, so that both frameworks can be handed the same inputs."""
from __future__ import annotations

import numpy as np
import torch


def _leaf(a, device: torch.device) -> torch.Tensor:
    a = np.array(a, order="C")  # a copy: a JAX array's buffer is read-only
    if a.dtype.name == "bfloat16":  # ml_dtypes.bfloat16; torch.from_numpy rejects it
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def to_torch(tree, device):
    """Turn the arrays of ``tree`` into tensors on ``device``.

    ``tree`` is an array or a dict, list or tuple nesting arrays, as the JAX
    side returns them.  A leaf with ``__array__`` (a NumPy or JAX array)
    becomes a tensor of the same dtype and values, bf16 included; other
    leaves (Python numbers, strings, None) stay as they are.
    """
    device = torch.device(device)
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_torch(v, device) for v in tree)
    if hasattr(tree, "__array__"):
        return _leaf(tree, device)
    return tree


def params_from_jax(tree, cfg, device) -> "torch.nn.Module":
    """The reference's parameter tree (``repro.models.init_params``) as the
    port's ``Transformer`` on ``device``.

    ``tree`` holds NumPy or JAX arrays (bf16 included) or tensors from
    ``to_torch``.  Each array under ``tree["layers"]``, at any depth
    (``layers/tm/ln_x/scale``), has a leading L dimension that is
    unstacked into the blocks: a block's parameter
    ``blocks.<i>.<a>.<b>`` is ``layers/<a>/<b>[i]``, so stacked experts
    (L, E, d, f) give each block one (E, d, f) parameter.  Every leaf must
    find a parameter of the same shape and dtype (fp32 leaves beside bf16
    ones stay fp32) and every parameter a leaf, or it raises.
    """
    from repro_torch.models.transformer import Transformer

    device = torch.device(device)
    src = to_torch(tree, "cpu")
    model = Transformer(cfg, device)
    want = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "blocks":  # blocks.<i>.<path> <- layers/<path>[i]
            want[("layers", *parts[2:], int(parts[1]))] = p
        else:
            want[tuple(parts)] = p
    have = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        elif path[0] == "layers":
            for i in range(node.shape[0]):
                have[path + (i,)] = node[i]
        else:
            have[path] = node

    walk(src, ())
    if set(have) != set(want):
        raise ValueError(f"params_from_jax: the trees differ: only in JAX's "
                         f"{sorted(set(have) - set(want), key=str)}, only in the port's "
                         f"{sorted(set(want) - set(have), key=str)}")
    with torch.no_grad():
        for key, p in want.items():
            a = have[key]
            if a.shape != p.shape or a.dtype != p.dtype:
                raise ValueError(f"params_from_jax: {key}: JAX has {tuple(a.shape)} "
                                 f"{a.dtype}, the port {tuple(p.shape)} {p.dtype}")
            p.copy_(a)
    return model


def opt_state_from_jax(state, model) -> dict:
    """The reference's optimizer state (``repro.optim.init_state`` /
    ``apply_updates``: ``{"step", "leaves": {... {"master", "m", "v"[,
    "m_scale", "v_scale"]}}}``) as the port's, keyed by ``model``'s
    parameter names and on its device.

    Leaves under ``layers`` are unstacked into the blocks as in
    ``params_from_jax``: block i takes row i of each array, and of a
    per-layer scale (L,); a scale shared by the stacked leaf, shape (),
    goes to every block.  Every parameter must find its entry, or it
    raises.
    """
    device = next(model.parameters()).device
    src = to_torch(state, "cpu")
    leaves = {}

    def walk(node, path):
        if "master" not in node:
            for k, v in node.items():
                walk(v, path + (k,))
            return
        if path[0] != "layers":
            leaves[".".join(path)] = node
            return
        for i in range(node["master"].shape[0]):
            leaves[".".join(("blocks", str(i)) + path[1:])] = {
                k: (v if k.endswith("_scale") and v.ndim == 0 else v[i])
                for k, v in node.items()}

    walk(src["leaves"], ())
    params = dict(model.named_parameters())
    if set(leaves) != set(params):
        raise ValueError(f"opt_state_from_jax: the trees differ: "
                         f"{sorted(set(leaves) ^ set(params))}")
    for name, s in leaves.items():
        if s["master"].shape != params[name].shape:
            raise ValueError(f"opt_state_from_jax: {name}: JAX has "
                             f"{tuple(s['master'].shape)}, the port "
                             f"{tuple(params[name].shape)}")
        leaves[name] = {k: v.clone().to(device) for k, v in s.items()}
    return {"step": src["step"].to(device), "leaves": leaves}
