"""Elastic re-mesh planning: shrink/grow the data axis across restarts; the
counterpart of ``repro.runtime.elastic``.

At 1000+ nodes the common failure is losing a host (8 GPUs): the job must
resume on a smaller mesh without waiting for repair.  The layout makes
this tractable: the pod axis is pure DP and the data axis is FSDP, so
re-sharding is a placement of the checkpoint on the new mesh (the
checkpointer stores whole tensors, so any mesh shape that divides the dims
works).  ``plan_elastic_mesh`` picks the largest viable (data, model) grid
for the surviving device count and recomputes the per-device residency.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig, MeshConfig, ShapeConfig
from repro_torch.core.residency import ResidencyPlanner


@dataclasses.dataclass(frozen=True)
class ElasticDecision:
    data: int
    model: int
    global_batch: int          # possibly reduced to stay divisible
    fits: bool
    note: str


def plan_elastic_mesh(arch: ArchConfig, shape: ShapeConfig,
                      surviving_devices: int, *, model_parallel: int = 16,
                      hbm_bytes: float | None = None, device=None) -> ElasticDecision:
    """Choose (data, model) for the surviving devices.

    Keeps the model axis fixed (TP degree is baked into layouts/kernels) and
    shrinks the data axis; the global batch shrinks proportionally if it no
    longer divides (sync-SGD semantics preserved via gradient accumulation).
    The planner's capacity is ``hbm_bytes`` per device, or the memory of
    ``device`` (default: the card; on the CPU ``hbm_bytes`` is required).
    """
    model = model_parallel
    if surviving_devices < model:
        # degrade TP last — halve until it fits the survivors
        while model > 1 and surviving_devices < model:
            model //= 2
    data = max(1, surviving_devices // model)
    batch = shape.global_batch
    if batch % data != 0:
        batch = (batch // data) * data or data
    planner = ResidencyPlanner(hbm_bytes, device=device)
    # residency accounting on the production grid, scaled to the shrunken one
    shrunk = dataclasses.replace(shape, global_batch=batch)
    plan = planner.plan(arch, shrunk, MeshConfig(False))
    scale = (16 * 16) / (data * model)
    fits = plan.device_bytes * scale <= planner.capacity
    note = (f"data={data} model={model} batch={batch} "
            f"(~{plan.device_bytes * scale / 2**30:.1f} GB/dev)")
    return ElasticDecision(data, model, batch, fits, note)
