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
