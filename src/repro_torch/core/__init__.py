"""core — the host<->device movement layer of the port (paper §II-B/C).

- advise:     the three CUDA UM advises as tensor-role policies
- placement:  MemorySpace -> the card or pinned host memory (probed)
- prefetch:   bulk async host->device transfer on a side stream
- streaming:  layer-weight streaming + offloaded remat
- residency:  the ResidencyPlanner (the paper's advises as a plan)
"""
from repro_torch.core.advise import (
    Accessor,
    Advise,
    AdviseDirective,
    AdvisePolicy,
    MemorySpace,
    paper_default_policy,
    set_accessed_by,
    set_preferred_location,
    set_read_mostly,
)
from repro_torch.core.placement import Placement, backend_supports_memory_kinds
from repro_torch.core.prefetch import PrefetchIterator, prefetch_to_device
from repro_torch.core.residency import (
    MemoryBudget,
    ResidencyPlan,
    ResidencyPlanner,
    plan_cell,
)

__all__ = [
    "Accessor", "Advise", "AdviseDirective", "AdvisePolicy", "MemorySpace",
    "paper_default_policy", "set_accessed_by", "set_preferred_location",
    "set_read_mostly", "Placement", "backend_supports_memory_kinds",
    "PrefetchIterator", "prefetch_to_device", "MemoryBudget", "ResidencyPlan",
    "ResidencyPlanner", "plan_cell",
]
