"""Model building blocks on PyTorch: the counterparts of ``repro.models``
(attention, common components, the MLP, MoE, the Mamba SSM, RWKV6 and the
transformer of all six families)."""
from repro_torch.models.transformer import (
    Transformer,
    decode_step,
    init_caches,
    init_params,
    loss_fn,
    prefill,
)

__all__ = [
    "Transformer",
    "decode_step",
    "init_caches",
    "init_params",
    "loss_fn",
    "prefill",
]
