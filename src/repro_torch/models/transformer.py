"""Composable decoder model covering all ten configs.

The counterpart of ``repro.models.transformer``.  Families:

  dense / moe / audio / vlm -> ``Block`` (GQA attention + MLP or MoE)
  ssm                       -> ``RWKVBlock`` (``repro_torch.models.rwkv``)
  hybrid                    -> ``Block`` with parallel attention + Mamba heads

The model is a ``Transformer`` module (an embedding, a list of blocks, a
final norm and an optional head) whose parameters keep the reference's
names, nesting, layouts and dtypes (``wq`` is (d, Hq*Dh), used as
``x @ w``; a block's experts are one (E, d, f) tensor), so that carrying
weights across (``repro_torch.interop.params_from_jax``) is a copy, not a
transpose.  The reference's ``lax.scan`` over stacked layers becomes a
loop over the blocks (``launch.step.build_prefill_step`` replays one
captured ``prefill_layer`` over them).  Entry points, as in the reference:

  loss_fn(params, batch, cfg)                        training loss (+ MoE aux)
  prefill(params, batch, cfg)                        logits + caches
  prefill_layer(blk, x, positions, cfg)              one layer of it (the scan body)
  decode_step(params, batch, caches, cache_len, cfg) one-token serve step

Caches are stacked with a leading L: K/V (L, B, S, Hkv, Dh), ring buffers
of window size for sliding-window archs; rwkv's token shifts and WKV
state; hybrid's K/V plus the Mamba conv and SSM states.  One deliberate
difference: ``decode_step`` writes the new token's K/V row and the new
recurrent states into the cache tensors it is given and returns them,
where the reference returns new caches.  ``cache_len`` is an int or, as
the reference's traced ``int32`` scalar, a 0-d tensor on the caches'
device that the step never reads on the host, so that the step can be
captured in a CUDA graph (``launch.step.build_serve_step``).
"""
from __future__ import annotations

import functools
import math

import torch
from torch import nn
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import checkpoint

from repro_torch import spans
from repro_torch.configs.base import ModelConfig
from repro_torch.core.streaming import checkpoint_layer
from repro_torch.device import resolve
from repro_torch.kernels.paged_attention import ops as paged_ops
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import rwkv as rwkv_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.common import (
    BATCH,
    SEQ,
    UNC,
    Norm,
    _weight,
    apply_mrope,
    apply_norm,
    apply_rope,
    cross_entropy_loss,
    embed_tokens,
    get_sharding_mode,
    linear,
    merge_dims,
    shard_hint,
    split_ready,
    target_logit,
    text_mrope_positions,
    unembed,
)
from repro_torch.models.mlp import MLP, mlp


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def residual_hint(cfg: ModelConfig) -> tuple:
    """Residual-stream sharding between layers (DESIGN.md §6):
    sequence parallelism over the model axis for attention families;
    channel TP for rwkv (the time recurrence cannot scan a sharded seq)."""
    if cfg.family == "ssm":
        return (BATCH, UNC, SEQ)
    return (BATCH, SEQ, UNC)


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device, generator=None):
        super().__init__()
        d, hq, hkv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        std = d ** -0.5
        self.wq = _weight((d, hq * dh), std, generator, dtype, device)
        self.wk = _weight((d, hkv * dh), std, generator, dtype, device)
        self.wv = _weight((d, hkv * dh), std, generator, dtype, device)
        self.wo = _weight((hq * dh, d), (hq * dh) ** -0.5, generator, dtype, device)
        if cfg.qkv_bias:
            for name, n in (("bq", hq * dh), ("bk", hkv * dh), ("bv", hkv * dh)):
                setattr(self, name, nn.Parameter(
                    torch.zeros(n, dtype=dtype, device=device)))


class Block(nn.Module):
    """``ln1``, ``attn``, ``ln2`` and ``mlp`` or ``moe``; for the hybrid
    family also ``mamba`` (d_inner = Hq*Dh), ``attn_out_norm`` and
    ``ssm_out_norm``."""

    def __init__(self, cfg: ModelConfig, dtype, device, generator=None):
        super().__init__()
        self.ln1 = Norm(cfg.d_model, cfg.norm, dtype, device)
        self.attn = Attention(cfg, dtype, device, generator)
        self.ln2 = Norm(cfg.d_model, cfg.norm, dtype, device)
        if cfg.num_experts:
            self.moe = moe_lib.MoE(cfg.d_model, cfg.d_ff, cfg.num_experts, cfg.activation,
                                   dtype, device, generator)
        else:
            self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.activation, dtype, device, generator)
        if cfg.family == "hybrid":
            d_inner = cfg.num_heads * cfg.head_dim
            self.mamba = ssm_lib.Mamba(cfg.d_model, d_inner, cfg.ssm_state, dtype, device,
                                       generator)
            self.attn_out_norm = Norm(cfg.d_model, "rmsnorm", dtype, device)
            self.ssm_out_norm = Norm(cfg.d_model, "rmsnorm", dtype, device)


class Transformer(nn.Module):
    """The model's parameters.  With a ``generator`` they are drawn as the
    reference draws them (normal weights, zero biases, unit norm scales);
    with none they are left uninitialised, to be filled by a copy."""

    def __init__(self, cfg: ModelConfig, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.cfg = cfg
        dev = resolve(device)
        dtype = _dtype(cfg)
        shape = ((cfg.num_codebooks, cfg.padded_vocab, cfg.d_model)
                 if cfg.num_codebooks > 1 else (cfg.padded_vocab, cfg.d_model))
        self.embedding = _weight(shape, 0.02, generator, dtype, dev)
        self.blocks = nn.ModuleList(new_block(cfg, dev, generator)
                                    for _ in range(cfg.num_layers))
        self.final_norm = Norm(cfg.d_model, cfg.norm, dtype, dev)
        self.lm_head = (None if cfg.tie_embeddings
                        else _weight(shape, 0.02, generator, dtype, dev))

    def forward(self, batch):
        """Logits of every position (the full forward)."""
        x, positions = embed_inputs(self, batch, self.cfg)
        x, _ = backbone(self, x, self.cfg, positions)
        return logits_fn(self, x, self.cfg)


def new_block(cfg: ModelConfig, device, generator: torch.Generator | None = None) -> nn.Module:
    """One layer's parameters on ``device``: a ``RWKVBlock`` for the ssm
    family, else a ``Block``; drawn from ``generator``, or left
    uninitialised with none."""
    block = rwkv_lib.RWKVBlock if cfg.family == "ssm" else Block
    return block(cfg, _dtype(cfg), device, generator)


def init_params(cfg: ModelConfig, generator: torch.Generator, device=None) -> Transformer:
    """Random weights from ``generator`` (which lives on ``device``, default
    the card).  They cannot match ``jax.random``'s; tests carry weights
    across with ``params_from_jax`` instead."""
    return Transformer(cfg, device, generator)


# ---------------------------------------------------------------------------
# Blocks — full-sequence (train / prefill) path
# ---------------------------------------------------------------------------

def _project_qkv(p, x, cfg: ModelConfig):
    B, S, _ = x.shape
    q = linear(x, p.wq)
    k = linear(x, p.wk)
    v = linear(x, p.wv)
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = split_ready(q, -1, cfg.num_heads).reshape(B, S, cfg.num_heads, cfg.head_dim)
    k = split_ready(k, -1, cfg.num_kv_heads).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = split_ready(v, -1, cfg.num_kv_heads).reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    return q, k, v


def _rotate(q, k, positions, cfg: ModelConfig):
    if cfg.rope == "rope":
        return apply_rope(q, k, positions, cfg.rope_theta)
    if cfg.rope == "mrope":
        return apply_mrope(q, k, positions, cfg.rope_theta)
    return q, k


def attn_sublayer(p, x, cfg: ModelConfig, positions, *, return_kv=False,
                  mode: str = "train"):
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg)
    q, k = _rotate(q, k, positions, cfg)
    # SP attention: q stays sequence-sharded; K/V replicate along seq so the
    # score matrix shards on the query dim for any head count
    q = shard_hint(q, (BATCH, SEQ, UNC, UNC))
    k = shard_hint(k, (BATCH, None, UNC, UNC))
    v = shard_hint(v, (BATCH, None, UNC, UNC))
    if mode == "prefill" and S * k.shape[1] > 4096 * 4096:
        out = attn_lib.attention_flash(q, k, v, causal=True, window=cfg.sliding_window)
    else:
        out = attn_lib.attention(q, k, v, causal=True, window=cfg.sliding_window)
    out = linear(merge_dims(out, (B, S, -1), -1, cfg.num_heads), p.wo)
    if return_kv:
        return out, (k, v)
    return out


def _ffn(p, h, cfg: ModelConfig, **moe_kw):
    """MLP, or MoE for the moe family: (y, aux); an MLP's aux is 0.0."""
    if cfg.num_experts:
        return moe_lib.moe(p.moe, h, top_k=cfg.top_k, activation=cfg.activation, **moe_kw)
    return mlp(p.mlp, h, cfg.activation), 0.0


def transformer_block(p, x, cfg: ModelConfig, positions, *, return_kv=False,
                      mode: str = "train"):
    """One attention-family layer: (x, aux), or (x, aux, cache) with
    ``return_kv`` (cache: k, v, and for hybrid the Mamba conv and ssm
    states).  Hybrid mixes 0.5 (rmsnorm(attention) + rmsnorm(Mamba))."""
    h = apply_norm(x, p.ln1, cfg.norm)
    res = attn_sublayer(p.attn, h, cfg, positions, return_kv=return_kv, mode=mode)
    y, kv = res if return_kv else (res, None)
    cache = {"k": kv[0], "v": kv[1]} if return_kv else None
    if cfg.family == "hybrid":
        m_out, (conv_s, ssm_s) = ssm_lib.mamba(p.mamba, h)
        y = 0.5 * (apply_norm(y, p.attn_out_norm, "rmsnorm")
                   + apply_norm(m_out, p.ssm_out_norm, "rmsnorm"))
        if return_kv:
            cache.update(conv=conv_s, ssm=ssm_s)
    x = x + y
    y, aux = _ffn(p, apply_norm(x, p.ln2, cfg.norm), cfg)
    x = x + y
    return (x, aux, cache) if return_kv else (x, aux)


def backbone(params, x, cfg: ModelConfig, positions, *, remat: str = "none"):
    """Full-sequence pass over all layers. x: (B,S,d) embeddings.  Each
    layer runs under ``checkpoint_layer(..., remat)``.  Returns the normed
    hidden states and the MoE aux loss summed over the layers."""

    hint = residual_hint(cfg)
    x = shard_hint(x, hint)
    if cfg.family == "ssm":
        def body(carry, blk):
            h, aux = carry
            return shard_hint(rwkv_lib.rwkv_block(blk, h, cfg)[0], hint), aux
    else:
        def body(carry, blk):
            h, aux = carry
            h, a = transformer_block(blk, h, cfg, positions)
            return shard_hint(h, hint), aux + a

    body = checkpoint_layer(body, remat)
    carry = (x, torch.zeros((), dtype=torch.float32, device=x.device))
    for blk in params.blocks:
        carry = body(carry, blk)
    x, aux = carry
    return apply_norm(x, params.final_norm, cfg.norm), aux


def embed_inputs(params, batch, cfg: ModelConfig):
    """Embed tokens, or pass through stub-frontend embeddings (audio/vlm)."""
    if "embeds" in batch:
        x = batch["embeds"].to(_dtype(cfg))
    else:
        x = embed_tokens(params.embedding, batch["tokens"])
    B, S = x.shape[0], x.shape[1]
    text = torch.arange(S, device=x.device)[None].expand(B, S)
    if cfg.rope == "mrope":
        positions = batch.get("positions_thw")
        if positions is None:
            positions = text_mrope_positions(text)
    else:
        positions = batch.get("positions")
        if positions is None:
            positions = text
    return x, positions


def logits_fn(params, x, cfg: ModelConfig):
    w = params.embedding if cfg.tie_embeddings else params.lm_head
    logits = unembed(x, w)
    if cfg.padded_vocab != cfg.vocab_size:  # mask the padding columns
        pad = torch.arange(cfg.padded_vocab, device=x.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e30)
    # vocab-parallel logits: keep V sharded over model through the loss
    # (under pure-FSDP the model axis belongs to the batch — V unsharded)
    vshard = "model" if get_sharding_mode() == "2d" else None
    if logits.ndim == 4:  # (B,S,K,V) multi-codebook
        return shard_hint(logits, (BATCH, UNC, None, vshard))
    return shard_hint(logits, (BATCH, UNC, vshard))


CE_CHUNK = 512  # seq positions per chunked-CE block (pure-FSDP path)


def _chunked_ce(params, x, labels, cfg: ModelConfig):
    """Sequence-chunked vocab loss: never materializes the full (B,S,V)
    fp32 logits; each chunk's logits are recomputed in the backward pass
    (non-reentrant checkpoint).  Used under pure-FSDP."""
    nc = x.shape[1] // CE_CHUNK

    def chunk_nll(xc, lc):
        logits = logits_fn(params, xc, cfg).float()
        lse = torch.logsumexp(logits, dim=-1)
        tgt = target_logit(logits, lc.long())
        mask = (lc != -1).float()
        return ((lse - tgt) * mask).sum(), mask.sum()

    tot = cnt = 0.0
    for i in range(nc):
        sl = slice(i * CE_CHUNK, (i + 1) * CE_CHUNK)
        t, c = checkpoint(chunk_nll, x[:, sl], labels[:, sl], use_reentrant=False)
        tot, cnt = tot + t, cnt + c
    return tot / cnt.clamp_min(1.0)


def loss_fn(params, batch, cfg: ModelConfig, *, remat: str = "full"):
    """Next-token loss. batch: tokens (B,S) [or (B,S,K) audio; embeds for
    vlm/audio stubs] + labels; the MoE aux loss folded in."""
    x, positions = embed_inputs(params, batch, cfg)
    x, aux = backbone(params, x, cfg, positions, remat=remat)
    labels = batch["labels"]
    S = x.shape[1]
    if (get_sharding_mode() == "fsdp" and labels.ndim == 2
            and S % CE_CHUNK == 0 and S > CE_CHUNK):
        loss = _chunked_ce(params, x, labels, cfg)
    else:
        loss = cross_entropy_loss(logits_fn(params, x, cfg), labels)
    if cfg.num_experts:
        loss = loss + 0.01 * aux / cfg.num_layers
    return loss


# ---------------------------------------------------------------------------
# Serving: prefill + decode with stacked caches
# ---------------------------------------------------------------------------

def cache_seq_len(cfg: ModelConfig, max_seq: int) -> int:
    if cfg.sliding_window is not None:
        return min(max_seq, cfg.sliding_window)
    return max_seq


def init_caches(cfg: ModelConfig, batch: int, max_seq: int, device=None) -> dict:
    """Stacked (leading L) zero caches for decoding, on ``device`` (default
    the card)."""
    dev = resolve(device)
    dtype, L = _dtype(cfg), cfg.num_layers

    def zeros(*shape, dtype=dtype):
        return torch.zeros((L, batch) + shape, dtype=dtype, device=dev)

    if cfg.family == "ssm":
        n, h = rwkv_lib.head_size(cfg), rwkv_lib.num_wkv_heads(cfg)
        return {"tm_shift": zeros(cfg.d_model), "cm_shift": zeros(cfg.d_model),
                "wkv": zeros(h, n, n, dtype=torch.float32)}
    kv = (cache_seq_len(cfg, max_seq), cfg.num_kv_heads, cfg.head_dim)
    caches = {"k": zeros(*kv), "v": zeros(*kv)}
    if cfg.family == "hybrid":
        d_inner = cfg.num_heads * cfg.head_dim
        caches["conv"] = zeros(ssm_lib.CONV_K - 1, d_inner)
        caches["ssm"] = zeros(d_inner, cfg.ssm_state, dtype=torch.float32)
    return caches


def _write_row(cache, row, slot) -> None:
    """cache[:, slot] = row, in place; ``slot`` an int or a 0-d device
    tensor.  A tensor slot goes in through ``index_copy_``, which reads it
    on the device.  On a DTensor the row goes in through a functional
    update copied back whole: indexing a sharded dim gives a redistributed
    copy, not a view, and a write into it would be lost; ``slice_scatter``
    takes an int start only, so a DTensor takes an int slot."""
    if isinstance(cache, DTensor):
        if isinstance(slot, torch.Tensor):
            raise TypeError("decode on a mesh takes an int cache_len")
        cache.copy_(cache.slice_scatter(row[:, None].to(cache.dtype), dim=1,
                                        start=slot, end=slot + 1))
    elif isinstance(slot, torch.Tensor):
        cache.index_copy_(1, slot.reshape(1).long(), row[:, None].to(cache.dtype))
    else:
        cache[:, slot] = row


PAGE = 64  # positions a page of the paged kernel's view, where they divide the cache
CHUNK = 2048  # positions of one of the kernel's split-KV work items (at most)


def paged_decode_ok(k_cache, num_heads: int) -> bool:
    """Whether one-token attention over ``k_cache`` (..., S, Hkv, Dh) goes to
    the paged decode kernel (``kernels.paged_attention``): a plain tensor
    on a card, not a ``DTensor``, in bf16, with a head size the kernel
    takes and at most ``MAX_GROUP`` query heads a KV head.  Every other
    cache (on the CPU, in fp32, a mesh's shards) keeps the plain
    ``attention.decode_attention_partial``."""
    hkv, dh = k_cache.shape[-2:]
    return (not isinstance(k_cache, DTensor) and k_cache.device.type == "cuda"
            and k_cache.dtype == torch.bfloat16 and dh in paged_ops.HEAD_DIMS
            and num_heads // hkv <= paged_ops.MAX_GROUP)


@functools.cache
def page_size(seq: int) -> int:
    """The page of the kernel's view of a cache of ``seq`` positions, a
    divisor of ``seq``.  The kernel loads a page in TMA boxes of gcd(page,
    64) rows (``cp.async`` where the page is no multiple of 8) and cuts a
    sequence into work items of whole pages, about CHUNK positions each.
    So PAGE where it divides ``seq``; else, of the divisors up to CHUNK (and
    ``seq`` itself up to 1.5 CHUNK, where a split would add at most one
    short work item), the one with the largest box, the longest of those."""
    if seq % PAGE == 0:
        return PAGE
    fits = [d for d in range(1, min(seq, CHUNK) + 1) if seq % d == 0]
    if seq <= CHUNK * 3 // 2:
        fits.append(seq)
    return max(fits, key=lambda d: (math.gcd(d, PAGE) if d % 8 == 0 else 0, d))


def paged_view(batch: int, seq: int, cache_len, device) -> tuple:
    """The paged kernel's view of one step's (B, S, Hkv, Dh) layer caches,
    the same for every layer: (page size, block table, seq_lens).

    A layer's cache is a pool of B·S/psz pages of ``page_size(S)``
    positions (``kv_pool``), read in place through the identity block
    table.  ``seq_lens`` is ``cache_len + 1`` on the
    device (never read on the host), which the kernel clamps to S: the
    first min(cache_len + 1, S) slots, those a plain and a ring cache hold
    valid (attention over a set does not depend on the order of its
    slots)."""
    psz = page_size(seq)
    table = torch.arange(batch * seq // psz, dtype=torch.int32, device=device)
    if isinstance(cache_len, torch.Tensor):
        lens = (cache_len + 1).to(torch.int32).expand(batch).contiguous()
    else:
        lens = torch.full((batch,), cache_len + 1, dtype=torch.int32, device=device)
    return psz, table.view(batch, seq // psz), lens


def kv_pool(cache, page_size: int):
    """A layer's (B, S, Hkv, Dh) cache as the kernel's pool (B·S/page_size,
    page_size, Hkv, Dh): a view, no copy."""
    return cache.view(-1, page_size, *cache.shape[2:])


def _decode_attn(p, h, cfg: ModelConfig, k_cache, v_cache, cache_len, positions,
                 paged=None):
    """One-token attention against a (possibly ring-buffered) cache,
    k_cache/v_cache (B,Scache,Hkv,Dh), whose row at the new token's slot is
    overwritten in place.  ``cache_len``: an int or a 0-d device tensor.
    ``paged``: the step's ``paged_view`` where ``paged_decode_ok`` holds,
    which routes the attention to the paged kernel; None keeps the plain
    attention."""
    B = h.shape[0]
    q, k_new, v_new = _project_qkv(p, h, cfg)
    q, k_new = _rotate(q, k_new, positions, cfg)
    S_cache = k_cache.shape[1]
    ring = cfg.sliding_window is not None and S_cache == cfg.sliding_window
    if isinstance(cache_len, torch.Tensor):
        slot = (torch.remainder(cache_len, S_cache) if ring
                else cache_len.clamp(max=S_cache - 1))
    else:
        slot = cache_len % S_cache if ring else min(cache_len, S_cache - 1)
    _write_row(k_cache, k_new[:, 0], slot)
    _write_row(v_cache, v_new[:, 0], slot)
    if paged is not None:
        spans.count("attn.decode_kernel")
        psz, table, lens = paged
        out = paged_ops.paged_attention(q[:, 0].contiguous(), kv_pool(k_cache, psz),
                                        kv_pool(v_cache, psz), table, lens)
        return merge_dims(out, (B, 1, -1), -1, cfg.num_heads) @ p.wo
    spans.count("attn.decode_plain")
    # keep the cache SEQUENCE-sharded through the attention math (split-KV)
    k_cache = shard_hint(k_cache, (BATCH, "model", UNC, UNC))
    v_cache = shard_hint(v_cache, (BATCH, "model", UNC, UNC))
    n_valid = cache_len + 1
    if ring:
        valid = (torch.arange(S_cache, device=h.device)[None, :] < n_valid) | (n_valid >= S_cache)
        num, den, m = attn_lib.decode_attention_partial(
            q[:, 0], k_cache, v_cache, valid.expand(B, S_cache))
        out = attn_lib.combine_decode_partials(num, den, m, None).to(h.dtype)
    else:
        out = attn_lib.decode_attention(q[:, 0], k_cache, v_cache, n_valid)
    return merge_dims(out, (B, 1, -1), -1, cfg.num_heads) @ p.wo


def decode_block(p, h, cfg: ModelConfig, cache: dict, cache_len, positions, paged=None):
    """One layer, one token. h: (B,1,d); ``cache`` holds this layer's
    slices of the stacked caches, which are written in place; ``paged`` as
    ``_decode_attn`` takes it."""
    hn = apply_norm(h, p.ln1, cfg.norm)
    y = _decode_attn(p.attn, hn, cfg, cache["k"], cache["v"], cache_len, positions, paged)
    if cfg.family == "hybrid":
        m_out, (conv_s, ssm_s) = ssm_lib.mamba(p.mamba, hn, state=(cache["conv"], cache["ssm"]))
        y = 0.5 * (apply_norm(y, p.attn_out_norm, "rmsnorm")
                   + apply_norm(m_out, p.ssm_out_norm, "rmsnorm"))
        cache["conv"].copy_(conv_s)
        cache["ssm"].copy_(ssm_s)
    x = h + y
    # decode's MoE: capacity factor 2.0 over a group of the whole batch
    y, _ = _ffn(p, apply_norm(x, p.ln2, cfg.norm), cfg, capacity_factor=2.0,
                group_size=h.shape[0])
    return x + y


@torch.no_grad()
def decode_step(params, batch, caches, cache_len, cfg: ModelConfig):
    """One serve step: batch["tokens"]: (B,) [or (B,K)] -> logits + caches.

    cache_len: tokens already in the cache, an int or a 0-d integer tensor
    on the caches' device, which is read only on the device: the step makes
    no host read and no shape of it depends on the data.  The new token's
    K/V row and the new recurrent states are written into ``caches`` in
    place, and the same dict is returned.

    Where the K/V caches are plain bf16 tensors on a card that the paged
    decode kernel takes (``paged_decode_ok``), every layer's attention goes
    to that kernel, which reads the cache in place through one
    ``paged_view`` built for the step (counter ``attn.decode_kernel`` a
    layer); other caches take the plain attention (``attn.decode_plain``).
    """
    if isinstance(cache_len, torch.Tensor):
        dev = next(iter(caches.values())).device
        if cache_len.ndim or cache_len.device != dev:
            raise ValueError(f"decode_step: cache_len must be an int or a 0-d tensor on "
                             f"{dev}, not a {tuple(cache_len.shape)} tensor on "
                             f"{cache_len.device}")
    if cfg.family == "audio" and batch["tokens"].ndim == 2:
        tokens = batch["tokens"][:, None, :]       # (B,1,K)
    else:
        tokens = batch["tokens"][:, None]          # (B,1)
    if "embeds" in batch:
        x = batch["embeds"].to(_dtype(cfg))        # (B,1,d) stub frontends
    else:
        x = embed_tokens(params.embedding, tokens)
    B = x.shape[0]
    if isinstance(cache_len, torch.Tensor):
        positions = cache_len.expand(B, 1)
    else:
        positions = torch.full((B, 1), cache_len, dtype=torch.long, device=x.device)
    if cfg.rope == "mrope":
        positions = text_mrope_positions(positions)
    k = caches.get("k")
    paged = (paged_view(k.shape[1], k.shape[2], cache_len, k.device)
             if k is not None and paged_decode_ok(k, cfg.num_heads) else None)
    for i, blk in enumerate(params.blocks):
        cache = {name: c[i] for name, c in caches.items()}
        if cfg.family == "ssm":
            state = (cache["tm_shift"], cache["cm_shift"], cache["wkv"])
            x, new = rwkv_lib.rwkv_block(blk, x, cfg, state=state)
            for c, n in zip(state, new):
                c.copy_(n)
        else:
            x = decode_block(blk, x, cfg, cache, cache_len, positions, paged)
    x = apply_norm(x, params.final_norm, cfg.norm)
    return logits_fn(params, x, cfg)[:, 0], caches


def prefill_layer(blk, x, positions, cfg: ModelConfig):
    """One layer of ``prefill``, the body of the reference's scan over the
    layers: (x, cache), the cache this layer's part of ``prefill``'s, K/V
    cut to the last ``cache_seq_len`` positions; for ssm the token shifts
    and WKV state after the prompt, from a zero state; for hybrid also the
    Mamba states.  It reads nothing on the host, so that it can be
    captured in a CUDA graph (``launch.step.build_prefill_step``)."""
    if cfg.family == "ssm":
        x, (tm_s, cm_s, wkv_s) = rwkv_lib.rwkv_block(blk, x, cfg)
        return x, {"tm_shift": tm_s, "cm_shift": cm_s, "wkv": wkv_s}
    s_cache = cache_seq_len(cfg, x.shape[1])
    x, _, cache = transformer_block(blk, x, cfg, positions, return_kv=True, mode="prefill")
    x = shard_hint(x, residual_hint(cfg))
    cache["k"], cache["v"] = cache["k"][:, -s_cache:], cache["v"][:, -s_cache:]
    return x, cache


def prefill_logits(params, x, cfg: ModelConfig):
    """The last position's logits of the last layer's output x."""
    x = apply_norm(x, params.final_norm, cfg.norm)
    return logits_fn(params, x[:, -1:], cfg)[:, 0]


@torch.no_grad()
def prefill(params, batch, cfg: ModelConfig):
    """Full-sequence forward returning last-position logits + filled caches:
    the K/V of the last window (or all) positions; for ssm the token shifts
    and WKV state after the prompt; for hybrid also the Mamba states.  The
    eager loop over ``prefill_layer``, stacking the layers' caches."""
    x, positions = embed_inputs(params, batch, cfg)
    per_layer = []
    for blk in params.blocks:
        x, cache = prefill_layer(blk, x, positions, cfg)
        per_layer.append(cache)
    caches = {name: torch.stack([c[name] for c in per_layer]) for name in per_layer[0]}
    del per_layer
    return prefill_logits(params, x, cfg), caches
