"""Binding of the CUDA paged decode attention kernel
(``csrc/paged_attention.cu``), which replaces the Pallas TPU kernel
``_pa_kernel`` of ``repro.kernels.paged_attention.kernel``.  Bounded by
the bytes of the live pages, each read once per call; see the source for
the design."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

_ARGS = (_build.PTR,) * 6 + (_build.I64,) * 7 + (_build.F64,)
_ENTRY = {torch.float32: "um_paged_attention_f32",
          torch.bfloat16: "um_paged_attention_bf16"}
DTYPES = tuple(_ENTRY)
HEAD_DIMS = (16, 32, 64, 128)
MAX_GROUP = 16  # query heads per KV head


def paged_attention_cuda(q, kv_pool_k, kv_pool_v, block_table, seq_lens, out) -> None:
    """out = decode attention of the checked, non-empty q (B,Hq,Dh) over
    the pools (npages, psz, Hkv, Dh) through ``block_table``."""
    b, hq, dh = q.shape
    npages, psz, hkv, _ = kv_pool_k.shape
    _build.launch(_ENTRY[q.dtype], _ARGS, q.data_ptr(), kv_pool_k.data_ptr(),
                  kv_pool_v.data_ptr(), block_table.data_ptr(),
                  seq_lens.data_ptr(), out.data_ptr(), b, hq, hkv, dh, npages,
                  psz, block_table.shape[1], 1.0 / math.sqrt(dh), device=q.device)
