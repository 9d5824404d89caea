"""Attention: GQA with causal / sliding-window masks; prefill and decode.

The counterpart of ``repro.models.attention``: plain PyTorch, and the
plain versions that the port's flash and paged attention kernels are held
against.  Layouts are the JAX package's: q (B,Sq,Hq,Dh), k/v
(B,Skv,Hkv,Dh).  Softmax is fp32, with the same casts as the JAX side:
scores are computed in the input dtype and then taken to fp32, and the
probabilities are cast to ``v.dtype`` before the PV product.

Decode is split-KV (flash-decoding style): ``decode_attention_partial``
gives a shard's (numerator, denominator, running max), and
``combine_decode_partials`` merges them, across the ranks of a mesh axis
when each rank holds one shard of the cache.
"""
from __future__ import annotations

import math

import torch

from torch.distributed import _functional_collectives as funcol

from repro_torch.models.common import (
    current_mesh,
    get_sharding_mode,
    merge_dims,
    split_ready,
)

NEG_INF = -1e30


def repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """(B,S,Hkv,Dh) -> (B,S,Hkv*groups,Dh)."""
    if groups == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, groups, d).reshape(b, s, h * groups, d)


def causal_mask(q_len: int, kv_len: int, *, window: int | None = None,
                q_offset=0, device=None) -> torch.Tensor:
    """(q_len, kv_len) bool mask; True = attend."""
    qi = torch.arange(q_len, device=device)[:, None] + q_offset
    kj = torch.arange(kv_len, device=device)[None, :]
    m = kj <= qi
    if window is not None:
        m = m & (kj > qi - window)
    return m


def _attention_dense(q, k, v, *, causal, window, q_offset, mask, scale):
    """Grouped-GQA dense attention with no repeat_kv copy: scores per
    kv-head group as batched products laid out (B*Hkv, Sq*G, .), so that a
    sequence shard of q (or of its gradient) on a mesh stays the outer dim
    of each group that is flattened (see ``common.linear``).  ``mask``
    broadcasts against the reference's (B, Hkv, G, Sq, Skv) scores."""
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    qt = split_ready(q, 2, hkv).reshape(b, sq, hkv, g, dh).permute(0, 2, 1, 3, 4)
    kt = k.permute(0, 2, 3, 1).reshape(b * hkv, dh, skv)
    s = torch.bmm(qt.reshape(b * hkv, sq * g, dh), kt).view(b, hkv, sq, g, skv)
    s = s.float() * scale
    if causal:
        m = causal_mask(sq, skv, window=window, q_offset=q_offset, device=q.device)
        s = torch.where(m[None, None, :, None, :], s, NEG_INF)
    if mask is not None:
        s = torch.where(mask.reshape((1,) * (5 - mask.ndim) + mask.shape).transpose(2, 3),
                        s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    vt = v.permute(0, 2, 1, 3).reshape(b * hkv, skv, dh)
    o = torch.bmm(p.reshape(b * hkv, sq * g, skv), vt).view(b, hkv, sq, g, dh)
    return merge_dims(o.permute(0, 2, 1, 3, 4), (b, sq, hq, dh), 2, hkv)


FSDP_Q_CHUNK = 512  # query rows per block under pure-FSDP (seq unsharded)


def attention(q, k, v, *, causal: bool = True, window: int | None = None,
              q_offset=0, mask=None, softmax_scale: float | None = None):
    """q: (B,Sq,Hq,Dh), k/v: (B,Skv,Hkv,Dh) -> (B,Sq,Hq,Dh). fp32 softmax.

    The dense path, with the whole (Sq, Skv) score block in memory.  Under
    pure-FSDP (``get_sharding_mode() == "fsdp"``, the sequence unsharded)
    queries are processed in blocks of ``FSDP_Q_CHUNK`` rows, each against
    the KV range that its causal band and window reach, so that the fp32
    score transient stays bounded.
    """
    sq = q.shape[1]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if (get_sharding_mode() == "fsdp" and mask is None
            and sq > FSDP_Q_CHUNK and sq % FSDP_Q_CHUNK == 0):
        outs = []
        for i in range(sq // FSDP_Q_CHUNK):
            q_start = q_offset + i * FSDP_Q_CHUNK
            qc = q[:, i * FSDP_Q_CHUNK:(i + 1) * FSDP_Q_CHUNK]
            hi, lo = k.shape[1], 0
            if causal:
                hi = min(hi, q_start + FSDP_Q_CHUNK)
            if window is not None:
                lo = max(0, q_start - window + 1)
            outs.append(_attention_dense(
                qc, k[:, lo:hi], v[:, lo:hi], causal=causal, window=window,
                q_offset=q_start - lo, mask=None, scale=scale))
        return torch.cat(outs, dim=1)
    return _attention_dense(q, k, v, causal=causal, window=window,
                            q_offset=q_offset, mask=mask, scale=scale)


FLASH_BLOCK = 1024


def attention_flash(q, k, v, *, causal: bool = True, window: int | None = None,
                    q_offset: int = 0, softmax_scale: float | None = None,
                    block: int = FLASH_BLOCK):
    """Memory-bounded online-softmax attention (forward only).

    Streams KV in blocks of ``block`` positions with a running (max, sum,
    acc), grouped GQA: the JAX ``lax.scan`` becomes a Python loop.  Blocks
    wholly above the causal diagonal or before the window are skipped, as
    the JAX version's unrolled form skips them; a skipped block would leave
    the carry unchanged, so the result is the same.
    """
    b, sq, hq, dh = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    skv = k.shape[1]
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(dh)
    block = min(block, skv)
    nb = -(-skv // block)
    qg = split_ready(q, 2, hkv).reshape(b, sq, hkv, g, dh).float()
    qpos = q_offset + torch.arange(sq, device=q.device)

    m = torch.full((b, hkv, g, sq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hkv, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, sq, hkv, g, dh), dtype=torch.float32, device=q.device)
    for j in range(nb):
        lo, hi = j * block, min((j + 1) * block, skv)
        if causal and lo > q_offset + sq - 1:
            continue  # above the diagonal for every query
        if window is not None and hi - 1 <= q_offset - window:
            continue  # before the window of every query
        kj, vj = k[:, lo:hi], v[:, lo:hi]
        s = torch.einsum("bqkgd,bskd->bkgqs", qg, kj.float()) * scale
        kpos = torch.arange(lo, hi, device=q.device)
        mask = torch.ones((sq, hi - lo), dtype=torch.bool, device=q.device)
        if causal:
            mask = mask & (kpos[None, :] <= qpos[:, None])
        if window is not None:
            mask = mask & (kpos[None, :] > qpos[:, None] - window)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        del s
        corr = torch.exp(m - m_new)                   # (B,Hkv,G,Sq)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bkgqs,bskd->bqkgd", p.to(v.dtype), vj)
        acc = acc * corr.permute(0, 3, 1, 2)[..., None] + pv.float()
        m = m_new
    l = l.clamp_min(1e-20).permute(0, 3, 1, 2)[..., None]
    return (acc / l).reshape(b, sq, hq, dh).to(q.dtype)


def decode_attention_partial(q, k, v, valid_mask, softmax_scale: float | None = None):
    """One-token query against a shard of the KV cache.

    q: (B,Hq,Dh); k/v: (B,Skv,Hkv,Dh); valid_mask: (B,Skv) bool.
    Returns partials (numerator (B,Hq,Dh) fp32, denominator (B,Hq) fp32,
    running max (B,Hq) fp32) that combine exactly across shards.
    """
    b, hq, dh = q.shape
    hkv = k.shape[2]
    k = repeat_kv(k, hq // hkv)
    v = repeat_kv(v, hq // hkv)
    scale = softmax_scale if softmax_scale is not None else 1.0 / math.sqrt(dh)
    logits = torch.einsum("bhd,bkhd->bhk", q, k).float() * scale
    logits = torch.where(valid_mask[:, None, :], logits, NEG_INF)
    m = logits.amax(dim=-1)                             # (B,Hq)
    p = torch.exp(logits - m[..., None])                # (B,Hq,Skv)
    p = torch.where(valid_mask[:, None, :], p, 0.0)
    denom = p.sum(dim=-1)                               # (B,Hq)
    num = torch.einsum("bhk,bkhd->bhd", p.to(v.dtype), v).float()
    return num, denom, m


def combine_decode_partials(num, denom, m, axis_name: str | None):
    """Combine split-KV partials (flash-decoding combine).  With
    ``axis_name=None`` the partials are the whole cache's; with the name of
    an axis of the context mesh (``launch.mesh.mesh_context``) they are this
    rank's shard's, merged over that axis's ranks: the MAX of ``m``, each
    shard's correction exp(m - max), then the SUM of ``num`` and ``denom``."""
    if axis_name is not None:
        mesh = current_mesh()
        if mesh is None:
            raise ValueError(f"combine_decode_partials over {axis_name!r} needs a mesh "
                             "context (launch.mesh.mesh_context)")
        group = mesh.get_group(axis_name)
        g_m = funcol.all_reduce(m, "max", group)
        corr = torch.exp(m - g_m)
        num = funcol.all_reduce(num * corr[..., None], "sum", group)
        denom = funcol.all_reduce(denom * corr, "sum", group)
    return num / denom[..., None].clamp_min(1e-20)


def decode_attention(q, k_cache, v_cache, cache_len, *, window: int | None = None,
                     axis_name: str | None = None, seq_offset=0):
    """Single-step decode attention.

    q: (B,Hq,Dh); caches: (B,Smax,Hkv,Dh); ``seq_offset`` is the cache's
    first global position.  cache_len: number of valid tokens globally.
    """
    smax = k_cache.shape[1]
    pos = torch.arange(smax, device=q.device)[None, :] + seq_offset
    valid = pos < cache_len
    if window is not None:
        valid = valid & (pos > cache_len - 1 - window)
    valid = valid.expand(q.shape[0], smax)
    num, denom, m = decode_attention_partial(q, k_cache, v_cache, valid)
    return combine_decode_partials(num, denom, m, axis_name).to(q.dtype)


def update_kv_cache(k_cache, v_cache, k_new, v_new, cache_len):
    """Insert one token's K/V at position ``cache_len``.  Caches
    (B,Smax,Hkv,Dh), new (B,1,Hkv,Dh) or (B,Hkv,Dh).

    Returns new caches and leaves the given ones as they were, as the JAX
    version does.  As ``lax.dynamic_update_slice`` does, a start past the
    end is clamped so that the update fits.
    """
    if k_new.ndim == 3:
        k_new, v_new = k_new[:, None], v_new[:, None]
    n = k_new.shape[1]
    start = min(max(int(cache_len), 0), k_cache.shape[1] - n)
    k_cache = k_cache.slice_scatter(k_new.to(k_cache.dtype), dim=1,
                                    start=start, end=start + n)
    v_cache = v_cache.slice_scatter(v_new.to(v_cache.dtype), dim=1,
                                    start=start, end=start + n)
    return k_cache, v_cache
