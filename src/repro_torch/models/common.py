"""Shared model components: norms, rotary embeddings (RoPE / M-RoPE),
activations, embedding/unembedding, and the sharding hints.

The counterpart of ``repro.models.common``, in plain PyTorch with the
reference's casts: norms and rotations compute in fp32 and cast back to the
input dtype before the scale.  The sharding mode is kept as the reference
keeps it.  ``shard_hint`` is the reference's sharding constraint: under a
mesh (``launch.mesh.mesh_context``) it redistributes a DTensor to the
hint's placements, and it is the identity on a plain tensor or with no
mesh, so the model code runs unchanged on one device.
"""
from __future__ import annotations

import contextlib
import contextvars
import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

# Sharding mode: "2d" = TP over model + SP residual stream + FSDP over data
# (the baseline); "fsdp" = pure parameter sharding with the sequence
# unsharded, which takes the query-chunked attention and the chunked loss.
_SHARDING_MODE = "2d"
_PARAM_MODE = "2d"


def set_sharding_mode(mode: str) -> None:
    """"2d" (TP+SP+FSDP), "fsdp" (pure), "zero1" (TP params + data-sharded
    optimizer state; activation hints behave like 2d)."""
    global _SHARDING_MODE, _PARAM_MODE
    if mode not in ("2d", "fsdp", "zero1"):
        raise ValueError(f"unknown sharding mode {mode!r}")
    _SHARDING_MODE = "2d" if mode == "zero1" else mode
    _PARAM_MODE = mode


def get_param_mode() -> str:
    return _PARAM_MODE


def get_sharding_mode() -> str:
    return _SHARDING_MODE


# ---------------------------------------------------------------------------
# Sharding hints
# ---------------------------------------------------------------------------

# A spec is a tuple with one entry per tensor dim (missing trailing entries
# are None), as ``jax.sharding.PartitionSpec``: None (replicated), a mesh
# axis name, a tuple of names (the dim split over each, the first outermost)
# or one of the sentinels below.
BATCH = "__batch__"  # the DP axes of the context mesh
SEQ = "__seq__"      # "model" under 2D (TP+SP) sharding, unsharded under
                     # pure-FSDP ("model" joins the batch axes instead)
UNC = "__unconstrained__"  # the hint leaves this dim to the current layout

_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Set the mesh that ``shard_hint`` reads (``launch.mesh.mesh_context``
    is the entry point)."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def current_mesh():
    return _MESH.get()


def batch_axes_from_ctx() -> tuple[str, ...]:
    mesh = current_mesh()
    names = set(mesh.mesh_dim_names) if mesh is not None else set()
    axes = ("pod", "data", "model") if _SHARDING_MODE == "fsdp" else ("pod", "data")
    return tuple(a for a in axes if a in names)


def _names(entry) -> tuple[str, ...]:
    if entry is None or entry == UNC:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def spec_placements(spec, mesh, current=None) -> list:
    """DTensor placements on ``mesh`` for ``spec``: a dim over
    ("data", "model") is ``Shard(i)`` on both mesh dims, data outermost (JAX's
    major-to-minor order); over an axis of size 1 it is ``Replicate()``,
    the same tensor, which DTensor's views take where a shard of an inner
    dim they would flatten is refused.  A mesh dim that no entry names
    replicates, or, when ``current`` (the tensor's placements) shards an
    ``UNC`` dim over it, keeps that shard."""
    names = list(mesh.mesh_dim_names)
    sizes = dict(zip(names, mesh.shape))
    out = [Replicate() for _ in names]
    for i, entry in enumerate(spec):
        axes = _names(entry)
        if [names.index(a) for a in axes] != sorted(names.index(a) for a in axes):
            raise ValueError(f"spec entry {entry!r}: axes must follow the mesh's "
                             f"order {names}")
        for a in axes:
            if sizes[a] > 1:  # a shard over one device is the whole tensor
                out[names.index(a)] = Shard(i)
    if current is not None:
        named = {a for e in spec for a in _names(e)}
        for k, (a, cur) in enumerate(zip(names, current)):
            if (a not in named and isinstance(cur, Shard) and cur.dim < len(spec)
                    and spec[cur.dim] == UNC):
                out[k] = cur
    return out


def resolve_spec(spec) -> tuple:
    """The spec with ``BATCH`` and ``SEQ`` replaced by the context's axes."""
    out = []
    for e in spec:
        if e == BATCH:
            dp = batch_axes_from_ctx()
            out.append(dp if dp else None)
        elif e == SEQ:
            out.append("model" if _SHARDING_MODE == "2d" else None)
        else:
            out.append(e)
    return tuple(out)


def seq_sharded(x) -> bool:
    """Whether ``x`` is a DTensor that shards a dim between its first and
    its last (the sequence, under sequence parallelism).  A matrix product
    flattens those dims into the first, and DTensor (torch 2.11) cannot
    flatten such a shard."""
    return isinstance(x, DTensor) and any(
        isinstance(p, Shard) and 0 < p.dim % x.ndim < x.ndim - 1 for p in x.placements)


def on_mesh(x) -> bool:
    """Whether ``x`` is a DTensor on a mesh of more than one device (on one
    device every placement is whole and the plain operations run)."""
    return isinstance(x, DTensor) and x.device_mesh.size() > 1


def linear(x, w):
    """``x @ w`` for x (B, S, k) and w (k, n).  On a mesh it is a batched
    product with ``w`` broadcast over B, which flattens nothing, in the
    forward or the backward (whose gradient may come sequence-sharded
    where the input was not); elsewhere the plain product.

    On a mesh ``w`` is first gathered over every mesh dim that shards x's
    batch or sequence (FSDP's gather before use; its gradient
    reduce-scatters back), so that the product runs on x's own shards.
    Left to DTensor, whose cost model prices the broadcast weight at its
    expanded size, the product moved the activations or copies of the
    weight instead: most of the dry-run's link bytes (PERF.md §6)."""
    if x.ndim == 3 and on_mesh(x):
        if isinstance(w, DTensor):
            want = [Replicate() if isinstance(px, Shard) and px.dim % x.ndim < x.ndim - 1
                    else pw for pw, px in zip(w.placements, x.placements)]
            if want != list(w.placements):
                w = w.redistribute(w.device_mesh, want)
        # unsqueeze first: expand's own backward would view (1, k, n) as (k, n)
        return torch.bmm(x, w.unsqueeze(0).expand(x.shape[0], *w.shape))
    return x @ w


def split_ready(x, dim: int, parts: int):
    """``x`` ready for its dim ``dim`` to be split into ``parts`` outer
    pieces (heads): where the mesh dims that shard it do not divide
    ``parts``, they replicate it (a DTensor cannot unflatten an uneven
    shard; GSPMD pads).  The identity on a plain tensor."""
    if not isinstance(x, DTensor):
        return x
    dim = dim % x.ndim
    over = [k for k, p in enumerate(x.placements) if isinstance(p, Shard) and p.dim == dim]
    if parts % math.prod(x.device_mesh.shape[k] for k in over) == 0:
        return x
    return whole_dim(x, dim)


def whole_dim(x, dim: int):
    """The DTensor ``x`` with its dim ``dim`` replicated over the mesh dims
    that shard it (an all-gather), its other placements kept."""
    dim = dim % x.ndim
    want = [Replicate() if isinstance(p, Shard) and p.dim == dim else p for p in x.placements]
    if tuple(want) == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, want)


class _MergeDims(torch.autograd.Function):
    """A reshape that merges dims, whose backward readies the gradient for
    the split it makes (``split_ready``) before viewing it back."""

    @staticmethod
    def forward(ctx, x, shape, dim, parts):
        ctx.in_shape, ctx.dim, ctx.parts = x.shape, dim, parts
        return x.reshape(shape)

    @staticmethod
    def backward(ctx, g):
        return split_ready(g, ctx.dim, ctx.parts).reshape(ctx.in_shape), None, None, None


def merge_dims(x, shape, dim: int, parts: int):
    """``x.reshape(shape)`` that merges dim ``dim`` of the result from
    ``parts`` outer pieces (heads); on a DTensor the gradient's split back
    into them is made ready as the forward's ``split_ready`` makes it."""
    if isinstance(x, DTensor):
        return _MergeDims.apply(x, shape, dim, parts)
    return x.reshape(shape)


def replicate(x):
    """A DTensor made whole on every rank (an all-gather where it is
    sharded, a sum where it is partial); a plain tensor as it is.  For the
    operations that DTensor cannot run sharded."""
    if isinstance(x, DTensor) and any(not isinstance(p, Replicate) for p in x.placements):
        return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim)
    return x


def shard_hint(x, spec):
    """Redistribute the DTensor ``x`` to ``spec``'s placements on the
    context mesh; the identity with no mesh, on a plain tensor, or when the
    spec names no axis or one the mesh lacks (the reference's degradation
    to a no-op).  The BATCH sentinel pins the batch dim to the mesh's DP
    axes; UNC dims keep the shard they have; a dim that its axes do not
    divide is replicated."""
    mesh = current_mesh()
    if mesh is None or not isinstance(x, DTensor):
        return x
    resolved = resolve_spec(spec)
    needed = {a for e in resolved for a in _names(e)}
    if not needed or not needed <= set(mesh.mesh_dim_names):
        return x
    # a dim its axes do not divide stays whole (GSPMD would pad it; a
    # DTensor's uneven shard cannot be viewed across)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    resolved = tuple(None if _names(e) and x.shape[i] % math.prod(sizes[a] for a in _names(e))
                     else e for i, e in enumerate(resolved))
    want = spec_placements(resolved, mesh, x.placements)
    if tuple(want) == tuple(x.placements):
        return x
    return x.redistribute(mesh, want)

# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(x, scale, eps: float = 1e-6):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


def layernorm(x, scale, bias, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y.to(x.dtype) * scale + bias


class Norm(torch.nn.Module):
    """rmsnorm (``scale``) or layernorm (``scale``, ``bias``): ones and
    zeros at init, as in the reference."""

    def __init__(self, d: int, kind: str, dtype, device):
        super().__init__()
        self.scale = torch.nn.Parameter(torch.ones(d, dtype=dtype, device=device))
        if kind != "rmsnorm":
            self.bias = torch.nn.Parameter(torch.zeros(d, dtype=dtype, device=device))


def apply_norm(x, params, kind: str):
    """``params`` holds ``scale`` (and ``bias`` for layernorm), as
    attributes (a ``Norm`` module) or items (a dict)."""
    if isinstance(params, dict):
        scale, bias = params["scale"], params.get("bias")
    else:
        scale, bias = params.scale, getattr(params, "bias", None)
    if kind == "rmsnorm":
        return rmsnorm(x, scale)
    return layernorm(x, scale, bias)


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------

def gelu(x):
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def squared_relu(x):
    r = F.relu(x)
    return r * r


ACTIVATIONS = {
    "gelu": gelu,
    "silu": F.silu,
    "squared_relu": squared_relu,
    "relu": F.relu,
}


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------

def _inv_freq(half: int, theta: float, device) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=device) / half))


def rope_angles(positions, head_dim: int, theta: float):
    """positions: (..., S) int -> cos/sin (..., S, head_dim/2) fp32."""
    ang = positions.float()[..., None] * _inv_freq(head_dim // 2, theta, positions.device)
    return torch.cos(ang), torch.sin(ang)


def apply_rotary(x, cos, sin):
    """x: (B, S, H, Dh); cos/sin: (B, S, Dh/2) -> rotate half (GPT-NeoX style)."""
    half = x.shape[-1] // 2
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    cos = cos[:, :, None, :]
    sin = sin[:, :, None, :]
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(q, k, positions, theta: float):
    """Standard RoPE. positions: (B, S)."""
    cos, sin = rope_angles(positions, q.shape[-1], theta)
    return apply_rotary(q, cos, sin), apply_rotary(k, cos, sin)


# M-RoPE (Qwen2-VL, arXiv:2409.12191): the head_dim is split into three
# sections rotated by the temporal / height / width position streams.
MROPE_SECTION_FRACTIONS = (0.25, 0.375, 0.375)  # (t, h, w) — 16/24/24 of 64 half-dims


def apply_mrope(q, k, positions_thw, theta: float):
    """positions_thw: (B, S, 3) int32 — (t, h, w) coordinate streams."""
    half = q.shape[-1] // 2
    sizes = [int(round(f * half)) for f in MROPE_SECTION_FRACTIONS]
    sizes[-1] = half - sizes[0] - sizes[1]
    dev = positions_thw.device
    # which of (t, h, w) drives each frequency slot
    sec_id = torch.cat([torch.full((s,), i, dtype=torch.long, device=dev)
                        for i, s in enumerate(sizes)])
    pos = positions_thw.float()[..., sec_id]  # (B,S,half)
    ang = pos * _inv_freq(half, theta, dev)[None, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    return apply_rotary(q, cos, sin), apply_rotary(k, cos, sin)


def text_mrope_positions(positions):
    """For pure-text tokens all three M-RoPE streams equal the text position."""
    return torch.stack([positions] * 3, dim=-1)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def _normal(shape, std: float, generator, dtype, device) -> torch.Tensor:
    """N(0, std^2) drawn in ``dtype`` and scaled in ``dtype``, as the
    reference's ``jax.random.normal(key, shape, dtype) * std``."""
    return torch.randn(shape, generator=generator, dtype=dtype, device=device).mul_(std)


def _weight(shape, std, generator, dtype, device) -> torch.nn.Parameter:
    """N(0, std^2) from ``generator``, or uninitialised with none (to be
    filled by a copy)."""
    if generator is None:
        return torch.nn.Parameter(torch.empty(shape, dtype=dtype, device=device))
    return torch.nn.Parameter(_normal(shape, std, generator, dtype, device))


def _const(shape, value, dtype, device) -> torch.nn.Parameter:
    """A parameter filled with ``value``, as the reference inits it."""
    return torch.nn.Parameter(torch.full(shape, value, dtype=dtype, device=device))


def embed_tokens(emb, tokens):
    """tokens: (B,S) or (B,S,K) for multi-codebook audio.  The rows are
    taken by ``F.embedding``, whose backward DTensor shards (an indexing's
    ``index_put`` backward it cannot place in every torch version); a
    vocab-sharded DTensor table is gathered over the vocab first (its
    masked partial lookup has no backward there either)."""
    tokens = tokens.long()
    if isinstance(emb, DTensor):
        emb = whole_dim(emb, -2)
    if emb.ndim == 3:  # (K, V, d): sum of per-codebook embeddings (MusicGen)
        if tokens.ndim == 3:  # (B,S,K)
            out = F.embedding(tokens[..., 0], emb[0])
            for c in range(1, emb.shape[0]):
                out = out + F.embedding(tokens[..., c], emb[c])
            return out
        return F.embedding(tokens, emb[0])
    return F.embedding(tokens, emb)


def unembed(x, emb_or_head):
    """x: (B,S,d) -> logits (B,S,V) or (B,S,K,V) for multi-codebook."""
    w = emb_or_head
    if w.ndim == 3:  # (K, V, d)
        return torch.einsum("bsd,kvd->bskv", x, w)
    return linear(x, w.t())


def target_logit(logits, labels):
    """logits[..., labels] (labels < 0 read class 0).  On a DTensor the
    class is selected by comparison and a sum over the vocab, which may be
    sharded: a gather there takes DTensor's masked-partial path, which
    fails for these index shapes.  One term of each sum is not zero, so it
    is exact."""
    labels = labels.clamp_min(0)
    if isinstance(logits, DTensor):
        hit = torch.arange(logits.shape[-1], device=logits.device) == labels[..., None]
        return torch.where(hit, logits, 0.0).sum(dim=-1)
    return logits.gather(-1, labels[..., None])[..., 0]


def cross_entropy_loss(logits, labels, ignore_id: int = -1):
    """Mean next-token NLL in fp32; labels: (B,S) or (B,S,K).
    nll = logsumexp(z) - z[label], averaged over labels != ``ignore_id``."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    labels = labels.long()
    tgt = target_logit(logits, labels)
    mask = (labels != ignore_id).float()
    return ((lse - tgt) * mask).sum() / mask.sum().clamp_min(1.0)

