"""A routed-expert form for the benchmark's own tests, copied into a copy
of ``perfbench/forms/`` as ``mixtral.py``: Mixtral's block (arXiv:2401.04088),
the pre-norm GQA attention of ``_decoder`` and, in place of the MLP, a
router over ``num_local_experts`` SwiGLU experts, ``num_experts_per_tok`` of
them a token, their gates the softmax over every expert cut to the top k
(a tie to the lower index) and renormalised.

The reference routes every (token, choice) pair, with no capacity: the
port's ``models/moe.py`` drops the pairs past an expert's capacity, so the
two agree only where the port drops none, which the test counts
(``route`` is the seam it counts through).
"""
from __future__ import annotations

import torch

from perfbench.bounds import DTYPE_BYTES
from perfbench.forms import _decoder as D
from perfbench.forms._decoder import head, top_shapes  # noqa: F401
from perfbench.modelspec import ModelSpec, numel
from perfbench.reference.model import activation, attention, norm
from perfbench.reference.precision import FP32


def read(file: dict) -> dict:
    out = D.read(file, norm="rmsnorm", gated=True, eps_key="rms_norm_eps",
                 acts={"silu": "silu"})
    out["sizes"] = {"experts": file["num_local_experts"], "top_k": file["num_experts_per_tok"]}
    return out


def _experts(m: ModelSpec) -> dict:
    d, f, e = m.d, m.d_ff, m.sizes["experts"]
    return {"moe.w_gate": ((e, d, f), "normal", d ** -0.5),
            "moe.w_up": ((e, d, f), "normal", d ** -0.5),
            "moe.w_down": ((e, f, d), "normal", f ** -0.5)}


def block_shapes(m: ModelSpec) -> dict:
    router = {"moe.router": ((m.d, m.sizes["experts"]), "normal", m.d ** -0.5)}
    return {**D.attention_shapes(m), **D.norm_shapes(m, "ln2"), **router, **_experts(m)}


def route(p: dict, h, m: ModelSpec, mm=FP32):
    """(gates (..., k), experts (..., k)) of the tokens ``h``."""
    probs = torch.softmax(mm(h, p["moe.router"]), dim=-1)
    gates, chosen = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = m.sizes["top_k"]
    gates = gates[..., :k]
    return gates / gates.sum(-1, keepdim=True), chosen[..., :k]


def experts(p: dict, x, m: ModelSpec, mm=FP32):
    """The expert sublayer: the pre-norm ``ln2``, each token's experts
    weighted by their gates, the residual."""
    h = norm(x, p, "ln2", m)
    gates, chosen = route(p, h, m, mm)
    y = torch.zeros_like(x)
    for e in range(m.sizes["experts"]):
        w = (gates * (chosen == e)).sum(-1, keepdim=True)
        u = activation(mm(h, p["moe.w_gate"][e]), m.act) * mm(h, p["moe.w_up"][e])
        y = y + w * mm(u, p["moe.w_down"][e])
    return x + y


def layer(p: dict, x, m: ModelSpec, mm=FP32):
    return experts(p, attention(p, x, m, mm), m, mm)


def port_fields(m: ModelSpec) -> dict:
    return {**D.port_fields(m), "family": "moe", "num_experts": m.sizes["experts"],
            "top_k": m.sizes["top_k"]}


def layer_matrix_params(m: ModelSpec) -> int:
    """The attention's matrices, the router and the top k experts."""
    attn = sum(numel(s) for s, kind, _ in D.attention_shapes(m).values() if kind == "normal")
    one = sum(numel(s[1:]) for s, _, _ in _experts(m).values())
    return attn + m.d * m.sizes["experts"] + m.sizes["top_k"] * one


def decode_layer_bytes(m: ModelSpec, batch: int) -> int:
    """Everything but the experts, and the experts ``batch`` tokens can
    touch: min(E, batch k) of them."""
    touched = min(m.sizes["experts"], batch * m.sizes["top_k"])
    shapes = block_shapes(m)
    rest = sum(numel(s) for k, (s, _, _) in shapes.items() if k not in _experts(m))
    one = sum(numel(s[1:]) for s, _, _ in _experts(m).values())
    return (rest + touched * one) * DTYPE_BYTES[m.dtype]


def mixer_flops(m: ModelSpec) -> int:
    return 0
