"""LR schedules: linear warmup + cosine decay (the production default).

The counterpart of ``repro.optim.schedule``, computed in fp32 as the
reference computes it.  The lr is 0 at step 0, so the first update moves
only the moments."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, peak_lr: float, warmup_steps: int,
                  total_steps: int, final_frac: float = 0.1) -> torch.Tensor:
    """The lr at ``step`` (an int or a tensor) as a 0-d fp32 tensor on the
    step's device (the CPU for an int)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = peak_lr * step / max(warmup_steps, 1)
    progress = torch.clamp(
        (step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
    cos = peak_lr * (final_frac + (1 - final_frac) * 0.5 * (1 + torch.cos(math.pi * progress)))
    return torch.where(step < warmup_steps, warm, cos)
