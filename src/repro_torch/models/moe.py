"""Mixture-of-Experts: top-k routing with a capacity per expert.

The counterpart of ``repro.models.moe``, with the reference's routing kept
exactly: the router runs in fp32, the softmax over the E experts is cut to
its top k (a tie goes to the lower expert index, as ``jax.lax.top_k``
breaks it) and the chosen gates are renormalised.  Tokens are split into
groups of ``MOE_GROUP_SIZE``; each expert takes at most
C = max(top_k, int(group * top_k * capacity_factor / E)) (token, choice)
pairs a group, in token-major order (token 0 choice 0, token 0 choice 1,
token 1 choice 0, ...), and drops the rest.

Dispatch is by index where the reference builds (G, S, E, C) one-hot
tensors for its einsums (those exist for GSPMD's resharding): each kept
pair's token is copied into row (expert, group, slot) of a zero
(E, G*C, d) buffer, the experts run as batched products over it, and each
token sums its kept choices' rows, weighted by their gates.  A dropped
pair adds nothing, as in the reference.  Decode passes capacity factor 2.0
and a group of the whole batch, which still drops pairs when more than C
tokens choose one expert (ROADMAP.md §3).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.common import (
    BATCH,
    UNC,
    _weight,
    gelu,
    get_sharding_mode,
    replicate,
    seq_sharded,
    shard_hint,
    squared_relu,
    whole_dim,
)

MOE_GROUP_SIZE = 512
CAPACITY_FACTOR = 1.25  # GShard train default; decode passes 2.0


class MoE(nn.Module):
    """``router`` (d, E) fp32, ``w_gate``/``w_up`` (E, d, f) (``w_gate``
    for the gated activations only) and ``w_down`` (E, f, d), as the
    reference lays them out."""

    def __init__(self, d: int, f: int, num_experts: int, activation: str, dtype, device,
                 generator: torch.Generator | None = None):
        super().__init__()
        std_in, std_out = d ** -0.5, f ** -0.5
        self.router = _weight((d, num_experts), std_in, generator, torch.float32, device)
        if activation in ("swiglu", "geglu"):
            self.w_gate = _weight((num_experts, d, f), std_in, generator, dtype, device)
        self.w_up = _weight((num_experts, d, f), std_in, generator, dtype, device)
        self.w_down = _weight((num_experts, f, d), std_out, generator, dtype, device)


def _top_k(probs, k: int):
    """The k largest along the last axis and their indices, a tie going to
    the lower index (a stable descending sort), as ``jax.lax.top_k``."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _renormalise(gate_vals):
    """The chosen gates over their sum, floored at 1e-9 (Mixtral/GShard)."""
    return gate_vals / gate_vals.sum(dim=-1, keepdim=True).clamp_min(1e-9)


def _routing(x_flat, router_w, top_k: int, capacity: int, num_experts: int):
    """x_flat: (G,S,d) grouped tokens -> for each (token, choice) its gate
    (G,S,k) fp32, expert (G,S,k), slot in that expert's buffer (G,S,k) and
    whether it is kept (slot < capacity), and the Switch aux loss."""
    logits = x_flat.float() @ router_w                       # (G,S,E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = _top_k(probs, top_k)
    gate_vals = _renormalise(gate_vals)
    g, s, e = logits.shape
    # F.one_hot's equal: its CPU version checks the indices' range by reading
    # them on the host, which a captured decode step may not do
    onehot = (gate_idx[..., None] == torch.arange(e, device=gate_idx.device)).long()  # (G,S,k,E)
    # the slot: an exclusive count over the token-major (token, choice) order
    flat = onehot.reshape(g, s * top_k, e)
    pos = (flat.cumsum(dim=1) - flat).reshape(g, s, top_k, e)
    slot = pos.gather(-1, gate_idx[..., None])[..., 0]
    keep = slot < capacity
    # load-balancing auxiliary loss (Switch), over every choice, kept or not
    density = onehot.sum(dim=2).float().mean(dim=1)          # (G,E) token frac
    router_prob = probs.mean(dim=1)                          # (G,E)
    aux = (density * router_prob).sum(dim=-1).mean() * (e ** 2) / top_k
    return gate_vals, gate_idx, slot, keep, aux


def _groups(x, group_size: int | None, top_k: int, capacity_factor: float,
            num_experts: int):
    """x (B,S,d) as (G, group, d) and the capacity a group gives each
    expert, as the reference computes them; a token count that the group
    does not divide raises, as the reference's reshape fails."""
    b, s, d = x.shape
    tokens = b * s
    gsz = min(group_size or MOE_GROUP_SIZE, tokens)  # the global read at call time
    if tokens % gsz:
        raise ValueError(f"moe: {tokens} tokens do not split into groups of {gsz}")
    capacity = max(top_k, int(gsz * top_k * capacity_factor / num_experts))
    return x.reshape(tokens // gsz, gsz, d), capacity


def moe(p, x, *, top_k: int, activation: str,
        capacity_factor: float = CAPACITY_FACTOR, group_size: int | None = None):
    """x: (B,S,d) -> (y (B,S,d), aux loss)."""
    e = p.w_up.shape[0]
    # groups cut across the sequence: a sequence shard is gathered first
    x_flat, capacity = _groups(whole_dim(x, 1) if seq_sharded(x) else x, group_size, top_k,
                               capacity_factor, e)
    # groups shard over the DP axes; expert hidden shards over model (TP
    # inside the expert — E < model-axis size, DESIGN.md §6)
    x_flat = shard_hint(x_flat, (BATCH, UNC, UNC))
    g, s, d = x_flat.shape
    gate, expert, slot, keep, aux = _routing(x_flat, p.router, top_k, capacity, e)
    rows = e * g * capacity
    row = (expert * g + torch.arange(g, device=x.device)[:, None, None]) * capacity + slot
    # dispatch: one copy per choice; a dropped pair lands in a spare last row.
    # On a mesh the index dispatch and combine run on whole (replicated)
    # tensors, as GSPMD all-gathers for them: DTensor has no sharded
    # strategy for index_copy_ or for indexing by a tensor
    tokens = replicate(x_flat).reshape(g * s, d)
    row, keep = replicate(row), replicate(keep)
    buf = tokens.new_zeros((rows + 1, d))
    for j in range(top_k):
        buf.index_copy_(0, torch.where(keep[..., j], row[..., j], rows).reshape(-1), tokens)
    # the (E, G*C) rows are group-major within an expert: G*C shards like G
    xe = shard_hint(buf[:rows].view(e, g * capacity, d), (None, BATCH, UNC))
    if activation in ("swiglu", "geglu"):
        act = F.silu if activation == "swiglu" else gelu
        h = act(torch.bmm(xe, p.w_gate)) * torch.bmm(xe, p.w_up)
    else:
        act = gelu if activation == "gelu" else squared_relu
        h = act(torch.bmm(xe, p.w_up))
    h = shard_hint(h, (None, BATCH, "model" if get_sharding_mode() == "2d" else None))
    out = replicate(shard_hint(torch.bmm(h, p.w_down), (None, BATCH, UNC))).view(rows, d)
    # combine: each token's kept choices, weighted by their gates in x.dtype
    combine = (gate * keep).to(x.dtype)
    y = torch.einsum("gsk,gskd->gsd", combine, out[torch.where(keep, row, 0)])
    return y.reshape(x.shape), aux
