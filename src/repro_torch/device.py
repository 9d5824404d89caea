"""Device resolution for the port's entry points: the card by default, the
CPU only when the caller asks for it."""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``None`` means the CUDA card, and raises when there is none; there
    is no quiet fallback to the CPU.  Anything else is taken as given."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU by default; pass "
            "device='cpu' to run the kernels' plain versions on the CPU")
    return dev


def same_device(a: torch.device, b: torch.device) -> bool:
    """Whether a and b are one device; ``cuda`` is the current card."""
    def index(d):
        return torch.cuda.current_device() if d.type == "cuda" and d.index is None else d.index
    return a.type == b.type and index(a) == index(b)
