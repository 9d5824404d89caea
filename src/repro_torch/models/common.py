"""Shared model components: norms, rotary embeddings (RoPE / M-RoPE),
activations, embedding/unembedding.

The counterpart of ``repro.models.common``, in plain PyTorch with the
reference's casts: norms and rotations compute in fp32 and cast back to the
input dtype before the scale.  The sharding mode is kept as the reference
keeps it; ``shard_hint`` is the identity until the port has a device mesh.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

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


def shard_hint(x, spec=None):
    """The reference's sharding constraint; the identity on the port until
    it has a device mesh (one device, no constraint to state)."""
    return x

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
    """tokens: (B,S) or (B,S,K) for multi-codebook audio."""
    tokens = tokens.long()
    if emb.ndim == 3:  # (K, V, d): sum of per-codebook embeddings (MusicGen)
        if tokens.ndim == 3:  # (B,S,K)
            out = emb[0][tokens[..., 0]]
            for c in range(1, emb.shape[0]):
                out = out + emb[c][tokens[..., c]]
            return out
        return emb[0][tokens]
    return emb[tokens]


def unembed(x, emb_or_head):
    """x: (B,S,d) -> logits (B,S,V) or (B,S,K,V) for multi-codebook."""
    w = emb_or_head
    if w.ndim == 3:  # (K, V, d)
        return torch.einsum("bsd,kvd->bskv", x, w)
    return x @ w.t()


def cross_entropy_loss(logits, labels, ignore_id: int = -1):
    """Mean next-token NLL in fp32; labels: (B,S) or (B,S,K).
    nll = logsumexp(z) - z[label], averaged over labels != ``ignore_id``."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    labels = labels.long()
    tgt = logits.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
    mask = (labels != ignore_id).float()
    return ((lse - tgt) * mask).sum() / mask.sum().clamp_min(1.0)

