"""Binding of the CUDA flash attention kernel (``csrc/flash_attention.cu``),
which replaces the Pallas TPU kernel ``_fa_kernel`` of
``repro.kernels.flash_attention.kernel``.  Bounded by operations: bf16
runs Q K^T and P V on the tensor cores (wgmma, TMA loads), fp32 runs IEEE
FMAs on the CUDA cores; see the source for the design."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _build

_ARGS = (_build.PTR,) * 4 + (_build.I64,) * 8 + (_build.F64,)
_ENTRY = {torch.float32: "um_flash_attention_f32",
          torch.bfloat16: "um_flash_attention_bf16"}
DTYPES = tuple(_ENTRY)
HEAD_DIMS = (16, 32, 64, 128)


def flash_attention_cuda(q, k, v, out, *, causal: bool, window: int | None) -> None:
    """out = attention of the checked, non-empty q (B,Sq,Hq,Dh) over k/v
    (B,Skv,Hkv,Dh), queries at the last Sq positions."""
    b, sq, hq, dh = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    _build.launch(_ENTRY[q.dtype], _ARGS, q.data_ptr(), k.data_ptr(),
                  v.data_ptr(), out.data_ptr(), b, sq, skv, hq, hkv, dh,
                  int(causal), -1 if window is None else window,
                  1.0 / math.sqrt(dh), device=q.device)
