"""Public flash attention wrapper: the counterpart of
``repro.kernels.flash_attention.ops.flash_attention``.  The TPU block
sizes are dropped; the kernel masks ragged Sq and Skv itself."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.kernel import (
    DTYPES, HEAD_DIMS, flash_attention_cuda)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


def flash_attention(q, k, v, *, causal: bool = True, window: int | None = None,
                    use_kernel: bool = True):
    """GQA attention, q (B,Sq,Hq,Dh) over k/v (B,Skv,Hkv,Dh), with the
    queries at the last Sq positions; causal and an optional sliding
    window of ``window`` positions (causal only).  fp32 softmax; the result
    has q's dtype.

    CPU tensors, or ``use_kernel=False``, take the plain PyTorch version.
    CUDA tensors go to the kernel, which takes contiguous fp32 or bf16 of
    one dtype with Dh in {16, 32, 64, 128} at 16-byte aligned addresses,
    or raise.  bf16 rounds the probabilities to bf16 for the PV product,
    as the plain version does; fp32 keeps them in fp32.
    ``flash_attention.launches`` counts the kernel's launches.
    """
    if (q.ndim != 4 or k.ndim != 4 or k.shape != v.shape
            or q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3]
            or k.shape[2] == 0 or q.shape[2] % k.shape[2]):
        raise ValueError(f"flash_attention: want q (B,Sq,Hq,Dh) and k, v "
                         f"(B,Skv,Hkv,Dh) with Hkv dividing Hq, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window must be None or >= 1, got {window}")
    if window is not None and not causal:
        # the JAX ref drops the window when causal=False, its Pallas kernel keeps it
        raise ValueError("flash_attention: a window needs causal=True")
    if not use_kernel or q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    _build.require("flash_attention", (q, k, v), DTYPES)
    if not q.dtype == k.dtype == v.dtype:
        raise TypeError(f"flash_attention: dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"flash_attention: the kernel takes Dh in {HEAD_DIMS}, "
                         f"got {q.shape[3]}")
    if q.shape[0] * q.shape[2] > 65535:
        raise ValueError("flash_attention: the kernel takes B * Hq <= 65535")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: the kernel takes q, k, v at 16-byte "
                         "aligned addresses")
    out = torch.empty_like(q)
    if out.numel():
        flash_attention_cuda(q, k, v, out, causal=causal, window=window)
        flash_attention.launches += 1
    return out


flash_attention.launches = 0
