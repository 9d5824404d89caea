"""Plain PyTorch paged decode attention: the counterpart of
``repro.kernels.paged_attention.ref`` and the oracle of the CUDA kernel.
Gathers the pages, then runs the split-KV decode partial and combine.

``paged_attention_split_ref`` emulates the bf16 tensor-core kernel's
algorithm instead (used by the tests only, never by a wrapper)."""
from __future__ import annotations

import math

import torch

from repro_torch.models.attention import (
    NEG_INF,
    combine_decode_partials,
    decode_attention_partial,
)

# The bf16 kernel's tiling (csrc/paged_attention.cu: kTK, kConsumerWarps):
# stages of TILE_KEYS positions, each split among WARPS consumer warps.
TILE_KEYS, WARPS = 64, 4


def paged_attention_ref(q, kv_pool_k, kv_pool_v, block_table, seq_lens):
    """q: (B,Hq,Dh); pools: (npages, psz, Hkv, Dh);
    block_table: (B, pages_per_seq) int32; seq_lens: (B,) int32."""
    b = q.shape[0]
    psz = kv_pool_k.shape[1]
    pages = block_table.shape[1]
    idx = block_table.long()
    k = kv_pool_k[idx]                    # (B, pages, psz, Hkv, Dh)
    v = kv_pool_v[idx]
    k = k.reshape(b, pages * psz, *k.shape[3:])
    v = v.reshape(b, pages * psz, *v.shape[3:])
    pos = torch.arange(pages * psz, device=q.device)[None, :]
    valid = pos < seq_lens[:, None]
    num, den, m = decode_attention_partial(q, k, v, valid)
    return combine_decode_partials(num, den, m, None).to(q.dtype)


def _bf16(x):
    return x.to(torch.bfloat16).float()


def paged_attention_split_ref(q, kv_pool_k, kv_pool_v, block_table, seq_lens, *,
                              pages_per_chunk: int, p_parts: int = 2):
    """The bf16 kernel's algorithm in plain PyTorch, in fp32.

    Each sequence goes in chunks of ``pages_per_chunk`` pages (the kernel
    takes about 2,048 positions: 32 pages of 64); a chunk goes in tiles of
    TILE_KEYS positions, and warp w of WARPS keeps its own online softmax
    over positions w * TILE_KEYS / WARPS .. of every tile.  Scores are
    fp32 products of the inputs; P is fp32, and the P V product takes it
    as ``p_parts`` bf16 terms (2: hi = bf16(P), lo = bf16(P - hi); 1: hi
    alone), each product exact and summed in fp32.  The warps' partials
    are merged in warp order, then the live chunks' in chunk order, as
    ``combine_decode_partials`` merges shards; the result is
    acc / max(l, 1e-20) in q's dtype.  Block-table ids wrap once and are
    clamped into the pool, as the kernel does.
    """
    b, hq, dh = q.shape
    npages, psz, hkv, _ = kv_pool_k.shape
    pages = block_table.shape[1]
    g = hq // hkv
    nchunks = max(1, -(-pages // pages_per_chunk))
    cpos, span, sl = pages_per_chunk * psz, pages * psz, TILE_KEYS // WARPS
    dev = q.device
    lens = seq_lens.long().clamp(0, span)
    idx = block_table.long()
    idx = torch.where(idx < 0, idx + npages, idx).clamp(0, npages - 1)
    k = kv_pool_k[idx].reshape(b, span, hkv, dh).float()
    v = kv_pool_v[idx].reshape(b, span, hkv, dh).float()
    qg = q.float().reshape(b, hkv, g, dh)
    scale = 1.0 / math.sqrt(dh)

    c_i = torch.arange(nchunks, device=dev)
    chunk_end = torch.minimum(lens[:, None], (c_i + 1)[None, :] * cpos)   # (B, C)
    shape = (b, hkv, nchunks, WARPS, g)
    m = torch.full(shape, NEG_INF, device=dev)
    l = torch.zeros(shape, device=dev)
    acc = torch.zeros((*shape, dh), device=dev)
    offs = (torch.arange(WARPS, device=dev)[:, None] * sl
            + torch.arange(sl, device=dev)[None, :])                      # (W, sl)
    for t in range(-(-cpos // TILE_KEYS)):
        pos = c_i[:, None, None] * cpos + t * TILE_KEYS + offs[None]      # (C, W, sl)
        valid = pos[None] < chunk_end[:, :, None, None]                    # (B, C, W, sl)
        at = pos.clamp(max=span - 1).flatten()
        ks = k[:, at].reshape(b, *pos.shape, hkv, dh)
        vs = v[:, at].reshape(b, *pos.shape, hkv, dh)
        s = torch.einsum("bhgd,bcwshd->bhcwgs", qg, ks) * scale
        mask = valid[:, None, :, :, None, :]
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        vs = torch.where(valid[..., None, None], vs, 0.0)
        hi = _bf16(p)
        parts = (hi, _bf16(p - hi))[:p_parts]
        pv = sum(torch.einsum("bhcwgs,bcwshd->bhcwgd", part, vs) for part in parts)
        acc = acc * corr[..., None] + pv
        m = m_new

    def merge(m, l, acc, dim, live=None):
        """Rescale to the largest m over ``dim`` and sum in index order."""
        if live is not None:
            m = torch.where(live, m, NEG_INF)
        m_all = m.amax(dim, keepdim=True)
        w = torch.exp(m - m_all)
        if live is not None:
            w = torch.where(live, w, 0.0)
        l_sum = torch.zeros_like(m_all.squeeze(dim))
        a_sum = torch.zeros_like(acc.select(dim, 0))
        for i in range(m.shape[dim]):
            l_sum = l_sum + l.select(dim, i) * w.select(dim, i)
            a_sum = a_sum + acc.select(dim, i) * w.select(dim, i)[..., None]
        return m_all.squeeze(dim), l_sum, a_sum

    m, l, acc = merge(m, l, acc, 3)                                        # over warps
    live = (c_i[None, :] * cpos < lens[:, None])[:, None, :, None]         # (B, 1, C, 1)
    _, l, acc = merge(m, l, acc, 2, live.expand_as(m))                     # over chunks
    out = acc / l.clamp_min(1e-20)[..., None]
    return out.reshape(b, hq, dh).to(q.dtype)
