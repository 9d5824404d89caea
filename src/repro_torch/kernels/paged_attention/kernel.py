"""Binding of the CUDA paged decode attention kernels
(``csrc/paged_attention.cu``), which replace the Pallas TPU kernel
``_pa_kernel`` of ``repro.kernels.paged_attention.kernel``.  Bounded by
the bytes of the live pages, each read once per call.  bf16 runs on the
tensor cores over a TMA page ring, each sequence split into chunks of
about 2,048 positions whose fp32 partials a second kernel merges; fp32 runs
on the CUDA cores.  See the source for the design."""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build

_ARGS_F32 = (_build.PTR,) * 6 + (_build.I64,) * 7 + (_build.F64, _build.PTR)
_ARGS_BF16 = (_build.PTR,) * 7 + (_build.I64,) * 7 + (_build.F64, _build.PTR)
_ENTRY = {torch.float32: "um_paged_attention_f32",
          torch.bfloat16: "um_paged_attention_bf16"}
DTYPES = tuple(_ENTRY)
HEAD_DIMS = (16, 32, 64, 128)
MAX_GROUP = 16  # query heads per KV head


@functools.cache
def _scratch_bytes():
    fn = _build.library().um_paged_attention_bf16_scratch_bytes
    fn.argtypes = [_build.I64] * 6
    fn.restype = _build.I64
    return fn


def paged_attention_cuda(q, kv_pool_k, kv_pool_v, block_table, seq_lens, out) -> int:
    """out = decode attention of the checked, non-empty q (B,Hq,Dh) over
    the pools (npages, psz, Hkv, Dh) through ``block_table``; returns the
    number of kernels launched (bf16 2, fp32 1).

    bf16 also takes fp32 scratch for the partials of its work items, its
    size from the C side (68 MB at qwen2-72b decode_32k: B 128, Hkv 8, 16
    chunks, G 8, Dh 128); ``paged_attention_cuda.scratch_bytes`` holds the
    size of the last call's."""
    b, hq, dh = q.shape
    npages, psz, hkv, _ = kv_pool_k.shape
    pages = block_table.shape[1]
    launched = ctypes.c_int64(0)
    args = (b, hq, hkv, dh, npages, psz, pages, 1.0 / math.sqrt(dh),
            ctypes.addressof(launched))
    ptrs = (q.data_ptr(), kv_pool_k.data_ptr(), kv_pool_v.data_ptr(),
            block_table.data_ptr(), seq_lens.data_ptr(), out.data_ptr())
    if q.dtype == torch.bfloat16:
        scratch = torch.empty(_scratch_bytes()(b, hq, hkv, dh, psz, pages) // 4,
                              dtype=torch.float32, device=q.device)
        paged_attention_cuda.scratch_bytes = scratch.numel() * scratch.element_size()
        _build.launch(_ENTRY[q.dtype], _ARGS_BF16, *ptrs, scratch.data_ptr(), *args,
                      device=q.device)
    else:
        _build.launch(_ENTRY[q.dtype], _ARGS_F32, *ptrs, *args, device=q.device)
    return launched.value


paged_attention_cuda.scratch_bytes = 0
