"""Dense FFN variants: SwiGLU / GeGLU (3 matrices), GELU / squared-ReLU (2).

The counterpart of ``repro.models.mlp``.  Weights keep the reference's
names and layouts (``w_up`` is (d, f), used as ``x @ w``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import ACTIVATIONS, _normal, gelu, linear


class MLP(nn.Module):
    def __init__(self, d: int, f: int, activation: str, dtype, device,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.activation = activation
        std_in, std_out = d ** -0.5, f ** -0.5
        names = (("w_gate", (d, f), std_in),) if activation in ("swiglu", "geglu") else ()
        names += (("w_up", (d, f), std_in), ("w_down", (f, d), std_out))
        for name, shape, std in names:
            w = (torch.empty(shape, dtype=dtype, device=device) if generator is None
                 else _normal(shape, std, generator, dtype, device))
            setattr(self, name, nn.Parameter(w))

    def forward(self, x):
        return mlp(self, x, self.activation)


def mlp(params, x, activation: str):
    if activation in ("swiglu", "geglu"):
        act = F.silu if activation == "swiglu" else gelu
        h = act(linear(x, params.w_gate)) * linear(x, params.w_up)
    else:
        h = ACTIVATIONS[activation](linear(x, params.w_up))
    return linear(h, params.w_down)
