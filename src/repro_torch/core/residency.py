"""ResidencyPlanner — oversubscription management (paper §II-D), planned.

The port's copy of the planner part of ``repro.core.residency`` (which
imports no JAX): the simulator's residency-order primitives stay with the
UM simulator, which is not ported yet.

CUDA UM reacts to memory pressure with page faults + LRU eviction.  The
planner decides residency *ahead of time* instead: given (arch, shape, mesh)
it computes the per-device working set analytically and, when it exceeds
the device's memory, applies the paper's advises in priority order:

  1. int8 optimizer moments    (shrink before moving — beyond-paper)
  2. optimizer state -> HOST   (PREFERRED_LOCATION(HOST) + ACCESSED_BY(DEVICE),
                                the ZeRO-Offload pattern: pinned host memory,
                                fetched for the update and evicted after it)
  3. activation remat->offload (recompute + host-stage long-lived residuals)
  4. KV cache -> paged host tier (decode only)

The emitted ``ResidencyPlan`` is consumed by ``launch/step.py``.  The budget
accounts for the reference's production mesh only (``MeshConfig``: 16 x 16,
or 2 x 16 x 16), so it cannot plan for one card, though the port's steps
run on a one-device ``DeviceMesh`` (``launch/mesh.py``).  The capacity per device is the card's memory
(``torch.cuda.get_device_properties``) unless the caller gives
``hbm_bytes``; the planner states no size of its own.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig, MeshConfig, ShapeConfig
from repro_torch.core.advise import MemorySpace
from repro_torch.device import resolve

GB = 1024**3

HBM_HEADROOM = 0.92  # the caching allocator's fragmentation and workspaces
DTYPE_BYTES = {"bfloat16": 2, "float32": 4, "float16": 2, "int8": 1}


@dataclasses.dataclass
class MemoryBudget:
    """Per-device byte accounting, one entry per tensor role."""

    params: float = 0.0
    grads: float = 0.0
    opt_master: float = 0.0
    opt_moments: float = 0.0
    activations: float = 0.0
    kv_cache: float = 0.0
    embedding_io: float = 0.0   # logits/softmax working set

    def device_total(self, plan: "ResidencyPlan") -> float:
        t = self.params + self.grads + self.activations + self.embedding_io
        if plan.opt_space is MemorySpace.DEVICE:
            t += self.opt_master + self.opt_moments
        if not plan.kv_host_tier:
            t += self.kv_cache
        else:
            t += self.kv_cache * plan.kv_device_fraction
        return t

    def host_total(self, plan: "ResidencyPlan") -> float:
        t = 0.0
        if plan.opt_space is MemorySpace.HOST:
            t += self.opt_master + self.opt_moments
        if plan.kv_host_tier:
            t += self.kv_cache * (1 - plan.kv_device_fraction)
        return t

    def as_dict(self) -> dict[str, float]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class ResidencyPlan:
    arch: str
    shape: str
    mesh: MeshConfig
    budget: MemoryBudget
    opt_space: MemorySpace = MemorySpace.DEVICE
    int8_moments: bool = False
    remat: str = "full"
    kv_host_tier: bool = False
    kv_device_fraction: float = 1.0
    oversubscribed: bool = False          # working set > device memory before planning
    fits: bool = True                     # after planning
    decisions: list[str] = dataclasses.field(default_factory=list)

    @property
    def device_bytes(self) -> float:
        return self.budget.device_total(self)

    @property
    def host_bytes(self) -> float:
        return self.budget.host_total(self)

    def summary(self) -> dict:
        return {
            "arch": self.arch,
            "shape": self.shape,
            "mesh": "x".join(map(str, self.mesh.shape)),
            "device_gb": round(self.device_bytes / GB, 3),
            "host_gb": round(self.host_bytes / GB, 3),
            "oversubscribed": self.oversubscribed,
            "fits": self.fits,
            "opt_space": self.opt_space.value,
            "int8_moments": self.int8_moments,
            "remat": self.remat,
            "kv_host_tier": self.kv_host_tier,
            "decisions": list(self.decisions),
            "roles_gb": {k: round(v / GB, 3) for k, v in self.budget.as_dict().items()},
        }


class ResidencyPlanner:
    """Plans against ``hbm_bytes`` per device, or, when that is None, the
    memory of ``device`` (default: the card; raises without one).  On the
    CPU there is no device memory to read, so ``hbm_bytes`` is required."""

    def __init__(self, hbm_bytes: float | None = None, headroom: float = HBM_HEADROOM,
                 device=None):
        if hbm_bytes is None:
            dev = resolve(device)
            if dev.type != "cuda":
                raise ValueError(f"ResidencyPlanner: {dev} has no device memory to "
                                 "read; pass hbm_bytes")
            hbm_bytes = torch.cuda.get_device_properties(dev).total_memory
        self.capacity = hbm_bytes * headroom

    # -- working-set accounting -------------------------------------------------
    def _budget(self, arch: ArchConfig, shape: ShapeConfig, mesh: MeshConfig,
                *, int8_moments: bool, remat: str) -> MemoryBudget:
        m = arch.model
        b = MemoryBudget()
        pbytes = DTYPE_BYTES[m.dtype]
        n_param_shards = mesh.data_size // (mesh.shape[0] if mesh.multi_pod else 1) * mesh.model_size
        # params are sharded FSDP(data-within-pod) x TP(model); replicated across pods
        b.params = m.total_params() * pbytes / n_param_shards

        train = shape.kind == "train"
        if train:
            b.grads = b.params  # bf16 grads, reduce-scattered like params
            master = 4 if arch.train.master_dtype == "float32" else pbytes
            mom = 1 if int8_moments else 4
            # optimizer fully sharded over (data-within-pod x model)
            b.opt_master = m.total_params() * master / n_param_shards
            b.opt_moments = m.total_params() * 2 * mom / n_param_shards
            micro = max(1, arch.train.microbatches)
            tokens_per_dev = shape.tokens / mesh.data_size / micro
            # with full remat we keep one saved residual per layer (sequence-
            # sharded over model too) + one layer's recompute working set
            saves = m.num_layers * tokens_per_dev * m.d_model * pbytes / mesh.model_size
            layer_ws = tokens_per_dev * (4 * m.d_model + 2 * (m.d_ff if not m.num_experts else m.d_ff * m.top_k)) * pbytes / mesh.model_size
            if remat == "offload":
                saves = tokens_per_dev * m.d_model * pbytes / mesh.model_size * 2  # double buffer
            elif remat == "none":
                saves *= 6  # every sublayer output saved
            b.activations = saves + layer_ws
            # logits working set: tokens x vocab sharded over model
            b.embedding_io = tokens_per_dev * m.vocab_size * pbytes / mesh.model_size * m.num_codebooks
        else:
            tokens_per_dev = shape.tokens / mesh.data_size
            if shape.kind == "decode":
                tokens_per_dev = shape.global_batch / min(mesh.data_size, shape.global_batch)
            b.activations = tokens_per_dev * (6 * m.d_model + 2 * m.head_dim * max(m.num_heads, 1)) * pbytes / max(1, mesh.model_size // 4)
            b.embedding_io = tokens_per_dev * m.vocab_size * pbytes / mesh.model_size
            # KV cache (prefill builds it; decode holds it)
            eff_seq = shape.seq_len if m.sliding_window is None else min(shape.seq_len, m.sliding_window)
            if m.family == "ssm":
                kv_total = m.num_layers * shape.global_batch * (m.d_model * m.ssm_state + 2 * m.d_model) * 4
            else:
                kv_total = shape.global_batch * eff_seq * m.kv_bytes_per_token()
                if m.family == "hybrid":
                    kv_total += m.num_layers * shape.global_batch * (m.num_heads * m.head_dim * m.ssm_state) * 4
            # KV sharded over data (batch) and model (seq chunks / split-KV)
            kv_shards = min(mesh.data_size, shape.global_batch) * mesh.model_size
            b.kv_cache = kv_total / kv_shards
        return b

    # -- planning -----------------------------------------------------------------
    def plan(self, arch: ArchConfig, shape: ShapeConfig, mesh: MeshConfig) -> ResidencyPlan:
        um = arch.um
        int8 = arch.train.int8_moments
        remat = arch.train.remat
        budget = self._budget(arch, shape, mesh, int8_moments=int8, remat=remat)
        plan = ResidencyPlan(arch.name, shape.name, mesh, budget,
                             int8_moments=int8, remat=remat)

        naive = dataclasses.replace(plan, opt_space=MemorySpace.DEVICE,
                                    kv_host_tier=False)
        plan.oversubscribed = naive.device_bytes > self.capacity
        if plan.oversubscribed:
            plan.decisions.append(
                f"oversubscribed: naive working set "
                f"{naive.device_bytes / GB:.1f} GB > {self.capacity / GB:.1f} GB HBM"
            )

        if um.optimizer_offload == "on":
            plan.opt_space = MemorySpace.HOST
            plan.decisions.append("optimizer->host (forced by config)")

        # escalate until it fits (the paper's advise priority)
        if plan.device_bytes > self.capacity and shape.kind == "train":
            if not plan.int8_moments:
                plan.int8_moments = True
                plan.budget = self._budget(arch, shape, mesh, int8_moments=True, remat=plan.remat)
                plan.decisions.append("int8 optimizer moments (beyond-paper shrink-first)")
        if plan.device_bytes > self.capacity and shape.kind == "train" \
                and um.optimizer_offload in ("auto", "on"):
            if plan.opt_space is not MemorySpace.HOST:
                plan.opt_space = MemorySpace.HOST
                plan.decisions.append(
                    "optimizer state PREFERRED_LOCATION(HOST)+ACCESSED_BY(DEVICE) "
                    "(ZeRO-Offload pattern, streamed+double-buffered)"
                )
        if plan.device_bytes > self.capacity and shape.kind == "train":
            plan.remat = "offload"
            plan.budget = self._budget(arch, shape, mesh, int8_moments=plan.int8_moments, remat="offload")
            plan.decisions.append("activation remat -> host offload of residual saves")
        if plan.device_bytes > self.capacity and shape.kind == "decode":
            plan.kv_host_tier = True
            plan.kv_device_fraction = max(
                0.05,
                (self.capacity - (plan.device_bytes - plan.budget.kv_cache))
                / max(plan.budget.kv_cache, 1.0),
            )
            plan.decisions.append(
                f"KV cache paged host tier (device fraction "
                f"{plan.kv_device_fraction:.2f})"
            )
        if um.kv_host_tier and shape.kind == "decode" and not plan.kv_host_tier:
            plan.kv_host_tier = True
            plan.decisions.append("KV host tier (forced by config)")

        plan.fits = plan.device_bytes <= self.capacity
        if not plan.fits and um.oversubscription == "forbid":
            raise MemoryError(
                f"{arch.name}/{shape.name} does not fit and oversubscription "
                f"is forbidden: {plan.device_bytes / GB:.1f} GB"
            )
        if not plan.decisions:
            plan.decisions.append("fits in HBM; no offload required")
        return plan


def plan_cell(arch: ArchConfig, shape: ShapeConfig, mesh: MeshConfig, *,
              hbm_bytes: float | None = None, device=None) -> ResidencyPlan:
    return ResidencyPlanner(hbm_bytes, device=device).plan(arch, shape, mesh)
