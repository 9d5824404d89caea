"""Plain PyTorch paged decode attention: the counterpart of
``repro.kernels.paged_attention.ref`` and the oracle of the CUDA kernel.
Gathers the pages, then runs the split-KV decode partial and combine."""
from __future__ import annotations

import torch

from repro_torch.models.attention import (
    combine_decode_partials,
    decode_attention_partial,
)


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
