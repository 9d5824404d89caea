"""Plain PyTorch flash attention: the counterpart of
``repro.kernels.flash_attention.ref`` and the oracle of the CUDA kernel."""
from __future__ import annotations

from repro_torch.models.attention import attention


def flash_attention_ref(q, k, v, *, causal=True, window=None):
    """q: (B,Sq,Hq,Dh); k/v: (B,Skv,Hkv,Dh) -> (B,Sq,Hq,Dh).  Queries are
    the last Sq positions of the KV stream."""
    return attention(q, k, v, causal=causal, window=window,
                     q_offset=k.shape[1] - q.shape[1])
