"""Public paged decode attention wrapper: the counterpart of
``repro.kernels.paged_attention.ops.paged_attention``."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention.kernel import (
    DTYPES, HEAD_DIMS, MAX_GROUP, paged_attention_cuda)
from repro_torch.kernels.paged_attention.ref import paged_attention_ref


def paged_attention(q, kv_pool_k, kv_pool_v, block_table, seq_lens, *,
                    use_kernel: bool = True):
    """Decode attention over a paged KV pool.

    q: (B,Hq,Dh); pools: (npages, page_size, Hkv, Dh);
    block_table: (B, pages_per_seq) int32 physical page ids;
    seq_lens: (B,) int32 valid token counts.  The result has q's dtype.

    CPU tensors, or ``use_kernel=False``, take the plain PyTorch version.
    CUDA tensors go to the kernel, which takes contiguous fp32 or bf16 q and
    pools of one dtype, int32 block table and lengths, Dh in
    {16, 32, 64, 128} and at most 16 query heads per KV head, or raise.
    The dtype chooses the kernel.  bf16 runs the tensor-core kernel: the
    products on ``mma.sync`` with P as bf16 hi + lo parts (fp32-accurate),
    pages loaded by TMA (cp.async for a page size that is not a multiple
    of 8) into a shared-memory ring, each sequence split into chunks of
    about 2,048 positions whose fp32 partials (scratch that this call
    allocates, ``kernel.paged_attention_cuda.scratch_bytes``) a second
    kernel merges in chunk order: two launches, and the same bits for the
    same inputs.  fp32 runs the CUDA-core kernel in one launch; no main
    path runs it.
    ``paged_attention.launches`` counts the kernels launched.
    """
    if (q.ndim != 3 or kv_pool_k.ndim != 4 or kv_pool_k.shape != kv_pool_v.shape
            or kv_pool_k.shape[3] != q.shape[2] or kv_pool_k.shape[2] == 0
            or q.shape[1] % kv_pool_k.shape[2]
            or block_table.ndim != 2 or block_table.shape[0] != q.shape[0]
            or tuple(seq_lens.shape) != (q.shape[0],)):
        raise ValueError(
            f"paged_attention: want q (B,Hq,Dh), pools (npages,psz,Hkv,Dh) with "
            f"Hkv dividing Hq, block_table (B,P) and seq_lens (B,), got "
            f"{tuple(q.shape)}, {tuple(kv_pool_k.shape)}, {tuple(kv_pool_v.shape)}, "
            f"{tuple(block_table.shape)}, {tuple(seq_lens.shape)}")
    if not use_kernel or q.device.type == "cpu":
        return paged_attention_ref(q, kv_pool_k, kv_pool_v, block_table, seq_lens)
    _build.require("paged_attention", (q, kv_pool_k, kv_pool_v), DTYPES)
    _build.require("paged_attention", (block_table, seq_lens), (torch.int32,))
    if block_table.device != q.device:
        raise ValueError("paged_attention: the block table is on another device")
    if not q.dtype == kv_pool_k.dtype == kv_pool_v.dtype:
        raise TypeError(f"paged_attention: dtypes differ: {q.dtype}, "
                        f"{kv_pool_k.dtype}, {kv_pool_v.dtype}")
    if q.shape[2] not in HEAD_DIMS:
        raise ValueError(f"paged_attention: the kernel takes Dh in {HEAD_DIMS}, "
                         f"got {q.shape[2]}")
    if q.shape[1] // kv_pool_k.shape[2] > MAX_GROUP or q.shape[0] > 65535:
        raise ValueError(f"paged_attention: the kernel takes at most {MAX_GROUP} "
                         f"query heads per KV head and B <= 65535")
    out = torch.empty_like(q)
    if out.numel():
        paged_attention.launches += paged_attention_cuda(
            q, kv_pool_k, kv_pool_v, block_table, seq_lens, out)
    return out


paged_attention.launches = 0
