"""The optimizer: the counterparts of ``repro.optim`` (AdamW with fp32
masters and int8 moments, global-norm clipping, the warmup-cosine lr)."""
from repro_torch.optim.adamw import (
    AdamWConfig,
    apply_updates,
    clip_by_global_norm,
    global_norm,
    init_state,
)
from repro_torch.optim.schedule import warmup_cosine

__all__ = [
    "AdamWConfig", "apply_updates", "clip_by_global_norm", "global_norm",
    "init_state", "warmup_cosine",
]
