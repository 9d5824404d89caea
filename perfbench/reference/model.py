"""The decoder's pieces in plain PyTorch and fp32, and its forward pass.

The pieces that the forms (``perfbench/forms/``) build their layers from:
the norms (RMSNorm, LayerNorm), the activations, rotate-half RoPE over the
head (theta from the config), and the pre-norm GQA attention sublayer:
causal softmax in fp32 with scale Dh^-1/2 (and the sliding window where
the config has one and the sequence reaches it), the output projection,
the residual.  The layer itself is the form's (``form.layer``), as the
published architecture has it.

Layers are made one at a time from the seed (``perfbench.weights``) and
applied to all rows, a block of rows at a time, so that the reference fits
beside nothing and needs no copy of the program's weights.
"""
from __future__ import annotations

import math

import torch

from perfbench import weights as W
from perfbench.modelspec import ModelSpec, form_of
from perfbench.reference.precision import FP32


def norm(x, p: dict, prefix: str, m: ModelSpec):
    if m.norm == "rmsnorm":
        return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + m.norm_eps) * p[f"{prefix}.scale"]
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + m.norm_eps) * p[f"{prefix}.scale"] + p[f"{prefix}.bias"]


def activation(x, kind: str):
    if kind == "silu":
        return x * torch.sigmoid(x)
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def rope(x, positions, theta: float):
    """x (R, S, H, Dh): the two halves of each head rotated by position x
    1 / theta^(j / (Dh/2))."""
    half = x.shape[-1] // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = positions.to(torch.float32)[:, None] * inv[None, :]          # (S, half)
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(p: dict, x, m: ModelSpec, mm=FP32):
    """The attention sublayer over x (R, S, d), positions 0..S-1: the
    pre-norm ``ln1``, GQA attention, ``attn.wo`` and the residual."""
    r, s, _ = x.shape
    pos = torch.arange(s, device=x.device)
    h = norm(x, p, "ln1", m)
    q, k, v = mm(h, p["attn.wq"]), mm(h, p["attn.wk"]), mm(h, p["attn.wv"])
    if m.qkv_bias:
        q, k, v = q + p["attn.bq"], k + p["attn.bk"], v + p["attn.bv"]
    q = rope(q.view(r, s, m.heads, m.head_dim), pos, m.rope_theta)
    k = rope(k.view(r, s, m.kv_heads, m.head_dim), pos, m.rope_theta)
    v = v.view(r, s, m.kv_heads, m.head_dim)
    g = m.heads // m.kv_heads
    k = k.repeat_interleave(g, dim=2)           # query head j reads kv head j // g
    v = v.repeat_interleave(g, dim=2)
    scores = mm(q.transpose(1, 2), k.permute(0, 2, 3, 1)) / math.sqrt(m.head_dim)
    keep = pos[None, :] <= pos[:, None]
    if m.window is not None:
        keep = keep & (pos[None, :] > pos[:, None] - m.window)
    scores = scores.masked_fill(~keep, float("-inf"))
    o = mm(torch.softmax(scores, dim=-1), v.transpose(1, 2))         # (R, H, S, Dh)
    return x + mm(o.transpose(1, 2).reshape(r, s, m.heads * m.head_dim), p["attn.wo"])


def head(x, top: dict, m: ModelSpec, mm=FP32):
    """Logits (..., vocab) of the last layer's output."""
    x = norm(x, top, "final_norm", m)
    w = top["embedding"] if m.tie else top["lm_head"]
    return mm(x, w.t())


def fp32(tensors: dict) -> dict:
    return {k: v.to(torch.float32) for k, v in tensors.items()}


@torch.no_grad()
def served_logits(m: ModelSpec, seed: int, ids: torch.Tensor, first: int, mm=FP32,
                  block_rows: int = 4) -> torch.Tensor:
    """The logits (R, S - first, vocab) at positions first..S-1 of the
    sequences ``ids`` (R, S), computed layer by layer, each layer made
    from ``seed`` and applied to ``block_rows`` rows at a time."""
    form, dev = form_of(m), ids.device
    top = fp32(W.top(m, seed, dev))
    x = top["embedding"][ids.long()]
    for i in range(m.layers):
        p = fp32(W.block(m, i, seed, dev))
        for r in range(0, x.shape[0], block_rows):
            x[r:r + block_rows] = form.layer(p, x[r:r + block_rows], m, mm)
        del p
    return form.head(x[:, first:], top, m, mm)
