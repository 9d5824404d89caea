"""Pluggable memory-variant strategies — "how a variant executes a trace".

A :class:`VariantStrategy` lowers a declarative ``workload.Workload`` onto a
``UMSimulator``.  The lowering template (``lower``) is fixed — setup walk,
one staging point, compute walk, teardown walk — and each strategy overrides
only the hooks where the paper's variants actually differ:

================  ============================================================
``explicit``      cudaMalloc/cudaMemcpy staging of every host-initialized
                  region; device-only regions are plain allocations; result
                  readback is an explicit DtoH copy.  Oversubscription raises
                  (paper: 'the case does not exist with explicit allocation').
``um``            pure on-demand unified memory: no staging at all.
``um_advise``     issues the workload's advise hints — PRE_INIT hints before
                  host initialization, POST_INIT hints at the staging point —
                  plus any role-based :class:`AdvisePolicy` at allocation time.
``um_prefetch``   cudaMemPrefetchAsync of the workload's prefetch candidates
                  at the staging point.
``um_both``       advises, then prefetches (the paper's combined variant).
``um_prefetch_pipelined``
                  beyond-paper (DESIGN.md §11): capacity-aware pipelined
                  prefetch — per-kernel-step windows bounded by free +
                  safely-evictable capacity, replayed on the async copy
                  stream so copies overlap the previous step's compute;
                  avoids the staged variant's self-eviction under
                  oversubscription.  Available on all platforms.
``um_both_pipelined``
                  advises, then the pipelined prefetch schedule.
``svm_remote``    beyond-paper (PAPERS.md: *Shared Virtual Memory: Its Design
                  and Performance Implications for Diverse Applications*): an
                  always-coherent, remote-access-only tier.  Data stays in
                  host memory; the GPU reads/writes it through the coherent
                  link at link bandwidth — no faults, no migration, no
                  eviction, and therefore no oversubscription cliff.  Gated to
                  platforms with coherent access in *both* directions
                  (``host_can_access_device and device_can_access_host``);
                  elsewhere the cell is N/A, like explicit-oversubscribed.
``um_hybrid_counters``
                  beyond-paper (Schieffer et al., *Harnessing Integrated
                  CPU-GPU System Memory for HPC: a first look into Grace
                  Hopper*): remote-access first, with per-chunk hardware
                  access counters that promote (migrate) a chunk on its
                  N-th remote touch; promoted chunks participate in normal
                  LRU eviction, so the oversubscription cliff returns
                  gradually as the hot set grows.  ``threshold=0`` behaves
                  like ``um`` from the first touch; ``threshold=inf`` is
                  bit-identical to ``svm_remote``.  Same coherent-fabric
                  gate as ``svm_remote``.
``um_pinned_zero_copy``
                  host-pinned zero-copy (``cudaHostAlloc`` semantics) — the
                  degenerate no-coherence cousin of ``svm_remote`` (Cooper
                  et al.): data lives host-side forever and all GPU traffic
                  is remote at ``remote_access_efficiency``, with no faults,
                  migration or eviction.  Because only the *device* ever
                  maps the other side's memory, the gate is just
                  ``device_can_access_host`` — it exists on every PCIe
                  platform where ``svm_remote`` is N/A.
``um_adaptive_advise``
                  beyond-paper (DESIGN.md §12): ``um_advise`` with runtime
                  feedback — when the report's rolling thrash window shows
                  eviction pressure, the migration-hostile advises are
                  withdrawn (READ_MOSTLY duplication dropped, the paper's
                  P9 pathology; PREFERRED_LOCATION(DEVICE) un-pinned,
                  stopping eager-restore ping-pong).  Bit-identical to
                  ``um_advise`` whenever thrash never triggers.
``um_prefetch_adaptive``
                  beyond-paper (DESIGN.md §12): ``um_prefetch_pipelined``
                  with runtime feedback — per-step prefetch windows are
                  suspended while the thrash window shows eviction
                  pressure (their copies would evict still-needed data)
                  and resume when it clears.  Bit-identical to
                  ``um_prefetch_pipelined`` whenever thrash never triggers.
================  ============================================================

Strategies are stateless singletons held in a registry; ``get_strategy``
resolves the string names the sweep engine and the process pool ship around.
Registering a new strategy makes it a first-class member of the experiment
matrix — no app changes required (DESIGN.md §8).
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.advise import Advise, AdvisePolicy, MemorySpace
from repro_torch.core.simulator import SimPlatform, UMSimulator

from repro_torch.umbench import workload as wk


@dataclasses.dataclass(frozen=True)
class StrategySummary:
    """What a strategy *provably* does, for static analysis (umbound,
    DESIGN.md §16): the abstract interpreter and the context-armed lint
    rules (UML010/011) read this instead of sniffing class names.

    ``kind`` partitions the registry by data-motion model:

    * ``"explicit"`` — cudaMalloc/cudaMemcpy staging; no faults ever;
    * ``"migrate"``  — on-demand UM migration (possibly advised/prefetched);
    * ``"remote"``   — host-pinned zero-copy / SVM: no migration at all, so
      faults, HtoD/DtoH migration bytes, and evictions are exactly zero;
    * ``"hybrid"``   — access-counter promotion: remote until the per-chunk
      counter crosses ``counter_threshold``, migrating after.
    """

    name: str
    kind: str                        # explicit | migrate | remote | hybrid
    issues_advises: bool = False
    prefetch: str = "none"           # none | staged | pipelined
    adaptive: bool = False           # sheds advises / suspends windows on thrash
    counter_threshold: float | None = None


class VariantStrategy:
    """Base lowering: the pure on-demand UM behaviour (no staging)."""

    name = "um"
    uses_advises = False

    def available(self, platform: SimPlatform) -> bool:
        """Whether this memory model exists on ``platform`` (False => N/A)."""
        return True

    def static_summary(self) -> StrategySummary:
        """This strategy's provable data-motion summary (computed fresh —
        never stored on the instance, which the cell cache fingerprints)."""
        return StrategySummary(self.name, "migrate",
                               issues_advises=self.uses_advises)

    # -- the lowering template -------------------------------------------------
    def lower(self, workload: wk.Workload, sim: UMSimulator) -> None:
        # PRE_INIT hints are issued before host initialization of their
        # region: at each host write, every not-yet-issued hint whose region
        # is already allocated goes out (in hint order).  Hints on regions
        # allocated later wait for a later write; validate() guarantees the
        # region exists by the end of setup.
        pre = list(workload.advises_at(wk.PRE_INIT)) if self.uses_advises else []
        for step in workload.setup:
            if pre and isinstance(step, wk.HostWrite):
                ready = [h for h in pre if h.name in sim.regions]
                self._issue_advises(sim, ready)
                pre = [h for h in pre if h.name not in sim.regions]
            if isinstance(step, wk.Alloc):
                sim.alloc(step.name, step.nbytes, role=step.role)
                self.on_alloc(sim, step)
            else:
                sim.host_write(step.name, step.nbytes)
        if pre:
            self._issue_advises(sim, pre)
        self.stage(sim, workload)
        for idx, step in enumerate(workload.compute):
            self.before_step(sim, workload, idx, step)
            if isinstance(step, wk.KernelStep):
                sim.kernel(step.name, flops=step.flops, reads=list(step.reads),
                           writes=list(step.writes),
                           bytes_touched=step.bytes_touched,
                           partial=step.partial_map())
            elif isinstance(step, wk.HostWrite):
                sim.host_write(step.name, step.nbytes)
            elif isinstance(step, wk.ReadBack):
                # mid-trace readback (e.g. a staged output drain) lowers the
                # same way as a trailing one
                self.read_result(sim, step.name)
            elif isinstance(step, wk.Free):
                # every variant frees the same way: the lifetime end is part
                # of the trace, not of the memory model
                sim.free(step.name)
            else:
                sim.host_read(step.name, step.nbytes)
        for step in workload.teardown:
            if isinstance(step, wk.ReadBack):
                self.read_result(sim, step.name)
            else:
                sim.host_read(step.name, step.nbytes)

    # -- hooks -----------------------------------------------------------------
    def on_alloc(self, sim: UMSimulator, step: wk.Alloc) -> None:
        """Called right after each allocation (e.g. role-based advises)."""

    def stage(self, sim: UMSimulator, workload: wk.Workload) -> None:
        """Called once, between host initialization and the first kernel."""

    def before_step(self, sim: UMSimulator, workload: wk.Workload,
                    idx: int, step: wk.ComputeStep) -> None:
        """Called immediately before each compute step — the pipelined
        prefetch schedulers issue their per-step windows here so the copies
        overlap the previous step's compute (DESIGN.md §11)."""

    def read_result(self, sim: UMSimulator, name: str) -> None:
        sim.host_read(name)

    # -- serving hooks (DESIGN.md §13) -----------------------------------------
    # The serving tier has no static Workload trace to lower — regions appear
    # and disappear with requests — so the continuous-batching scheduler
    # drives these three hooks instead of ``lower``.  ``on_alloc`` is shared:
    # the scheduler calls it for every region (weights and each KV block), so
    # the role-based tiers (svm_remote, um_hybrid_counters,
    # um_pinned_zero_copy) behave identically in both worlds for free.

    def serving_stage(self, sim: UMSimulator, name: str) -> None:
        """Called once after the (host-initialized) weights region exists —
        the serving analogue of the workload staging point."""

    def serving_admit(self, sim: UMSimulator, name: str) -> None:
        """Called for each KV block right after its allocation.  The block
        is virgin — the prefill/decode kernels populate it device-side — so
        the default (and the prefetch tiers') action is nothing; explicit
        reserves device memory here and raises when it cannot."""

    def serving_step(self, sim: UMSimulator, names: list[str]) -> None:
        """Called immediately before each decode step with the KV blocks the
        step will read — the serving-aware counterpart of ``before_step``:
        the pipelined tiers prefetch next-step KV evicted to the host back
        onto the device here, bounded by free capacity."""

    @staticmethod
    def _issue_advises(sim: UMSimulator, hints) -> None:
        for h in hints:
            d = h.directive
            if d.advise is Advise.READ_MOSTLY:
                sim.advise_read_mostly(h.name)
            elif d.advise is Advise.PREFERRED_LOCATION:
                sim.advise_preferred_location(h.name, d.location)
            else:
                sim.advise_accessed_by(h.name, d.accessor)

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.name!r}>"


class UMStrategy(VariantStrategy):
    name = "um"


class ExplicitStrategy(VariantStrategy):
    name = "explicit"

    def static_summary(self) -> StrategySummary:
        return StrategySummary(self.name, "explicit")

    def stage(self, sim: UMSimulator, workload: wk.Workload) -> None:
        for nm in workload.host_written():
            sim.explicit_copy_to_device(nm)
        for nm in workload.device_only():
            sim.explicit_alloc(nm)

    def read_result(self, sim: UMSimulator, name: str) -> None:
        sim.explicit_copy_to_host(name)

    def serving_stage(self, sim: UMSimulator, name: str) -> None:
        sim.explicit_copy_to_device(name)

    def serving_admit(self, sim: UMSimulator, name: str) -> None:
        # cudaMalloc: the block must fit whole, up front — under KV
        # oversubscription this raises, and the cell reads N/A (the paper:
        # 'the case does not exist with explicit allocation')
        sim.explicit_alloc(name)


class UMAdviseStrategy(VariantStrategy):
    """Issues the workload's advise hints; an optional role-based
    :class:`AdvisePolicy` contributes extra directives at allocation time
    (equivalent to issuing them right after cudaMallocManaged)."""

    name = "um_advise"
    uses_advises = True

    def __init__(self, policy: AdvisePolicy | None = None):
        self.policy = policy

    def on_alloc(self, sim: UMSimulator, step: wk.Alloc) -> None:
        if self.policy is None:
            return
        for key in (step.name, step.role):
            hints = [wk.AdviseHint(step.name, d) for d in self.policy.for_role(key)]
            self._issue_advises(sim, hints)

    def stage(self, sim: UMSimulator, workload: wk.Workload) -> None:
        self._issue_advises(sim, workload.advises_at(wk.POST_INIT))

    def serving_stage(self, sim: UMSimulator, name: str) -> None:
        # weights are read-only for the whole trace: the serving analogue of
        # the workloads' READ_MOSTLY hints
        sim.advise_read_mostly(name)

    def serving_admit(self, sim: UMSimulator, name: str) -> None:
        # the static "keep KV close" advise — pins each block to the device,
        # which backfires under KV oversubscription exactly like the paper's
        # P9 pathology (and is what um_adaptive_advise sheds at runtime)
        sim.advise_preferred_location(name, MemorySpace.DEVICE)


class UMPrefetchStrategy(VariantStrategy):
    name = "um_prefetch"

    def static_summary(self) -> StrategySummary:
        return StrategySummary(self.name, "migrate",
                               issues_advises=self.uses_advises,
                               prefetch="staged")

    def stage(self, sim: UMSimulator, workload: wk.Workload) -> None:
        for nm in workload.prefetch:
            sim.prefetch(nm)

    def serving_stage(self, sim: UMSimulator, name: str) -> None:
        sim.prefetch(name)


class UMBothStrategy(UMAdviseStrategy):
    name = "um_both"

    def static_summary(self) -> StrategySummary:
        return StrategySummary(self.name, "migrate", issues_advises=True,
                               prefetch="staged")

    def stage(self, sim: UMSimulator, workload: wk.Workload) -> None:
        super().stage(sim, workload)
        for nm in workload.prefetch:
            sim.prefetch(nm)

    def serving_stage(self, sim: UMSimulator, name: str) -> None:
        super().serving_stage(sim, name)
        sim.prefetch(name)


class PipelinedScheduleMixin:
    """The §11 schedule lowering, shared by the pipelined tiers: derive (or
    degenerate to) a :class:`~repro_torch.umbench.schedule.PrefetchPlan`, replay
    its staging-anchored windows at the staging point and each per-step
    window in ``before_step`` so the copies overlap the anchor step's
    compute.

    ``staged=True`` selects the degenerate single-window schedule (the
    whole candidate list at the staging point) — bit-identical to
    ``um_prefetch`` by construction, which is how the mechanism is pinned
    without new seed-model code (tests/test_prefetch_schedule.py).
    ``lookahead`` overrides the workload's ``prefetch_lookahead`` depth."""

    lookahead: int | None = None
    staged: bool = False

    def plan(self, workload: wk.Workload, sim: UMSimulator):
        from repro_torch.umbench import schedule
        if self.staged:
            return schedule.staged_plan(workload)
        return schedule.derive_plan(workload, sim.device_capacity,
                                    sim.chunk_bytes, self.lookahead)

    def issue_staging(self, sim: UMSimulator, workload: wk.Workload) -> None:
        from repro_torch.umbench import schedule
        self.plan(workload, sim).issue(sim, schedule.STAGING)

    def before_step(self, sim: UMSimulator, workload: wk.Workload,
                    idx: int, step: wk.ComputeStep) -> None:
        self.plan(workload, sim).issue(sim, idx)

    def serving_step(self, sim: UMSimulator, names: list[str]) -> None:
        """The serving-aware prefetch window (DESIGN.md §13): pull the next
        decode step's KV blocks that were evicted to the host back onto the
        device over the async copy stream, bounded by *free* capacity — a
        window that would have to evict would evict KV the same step is
        about to read.  Blocks with virgin chunks are skipped (only the
        newest gen block): there is nothing host-side to copy yet."""
        free = sim.device_capacity - sim.device_used
        for nm in names:
            r = sim.regions[nm]
            nonres = ~r.resident_mask()
            if (nonres & ~r.populated).any():
                continue
            miss = int(r.sizes[nonres].sum())
            if 0 < miss <= free:
                sim.prefetch(nm)
                free -= miss


class UMPrefetchPipelinedStrategy(PipelinedScheduleMixin, VariantStrategy):
    """Capacity-aware pipelined prefetch (DESIGN.md §11): instead of one
    monolithic ``cudaMemPrefetchAsync`` of every candidate at the staging
    point — which under oversubscription *self-evicts* (the tail of the
    bulk copy evicts the head before the first kernel runs) — the schedule
    module derives per-kernel-step prefetch windows bounded by
    free-plus-safely-evictable capacity, and this strategy replays them."""

    name = "um_prefetch_pipelined"

    def __init__(self, lookahead: int | None = None, staged: bool = False):
        self.lookahead = lookahead
        self.staged = staged

    def static_summary(self) -> StrategySummary:
        return StrategySummary(self.name, "migrate",
                               issues_advises=self.uses_advises,
                               prefetch="staged" if self.staged
                               else "pipelined")

    def stage(self, sim: UMSimulator, workload: wk.Workload) -> None:
        self.issue_staging(sim, workload)

    def serving_stage(self, sim: UMSimulator, name: str) -> None:
        sim.prefetch(name)


class UMBothPipelinedStrategy(PipelinedScheduleMixin, UMAdviseStrategy):
    """Advises plus the capacity-aware pipelined prefetch schedule — the
    pipelined counterpart of ``um_both`` (advise staging from
    :class:`UMAdviseStrategy`, windows from the mixin)."""

    name = "um_both_pipelined"

    def __init__(self, policy: AdvisePolicy | None = None,
                 lookahead: int | None = None, staged: bool = False):
        super().__init__(policy)
        self.lookahead = lookahead
        self.staged = staged

    def static_summary(self) -> StrategySummary:
        return StrategySummary(self.name, "migrate", issues_advises=True,
                               prefetch="staged" if self.staged
                               else "pipelined")

    def stage(self, sim: UMSimulator, workload: wk.Workload) -> None:
        UMAdviseStrategy.stage(self, sim, workload)
        self.issue_staging(sim, workload)

    def serving_stage(self, sim: UMSimulator, name: str) -> None:
        UMAdviseStrategy.serving_stage(self, sim, name)
        sim.prefetch(name)


class SVMRemoteStrategy(VariantStrategy):
    """SVM-style always-coherent tier: every allocation is pinned to host
    memory and the device accesses it remotely over the coherent link.
    Lowered through the simulator's PREFERRED_LOCATION(HOST) + zero-copy
    path, so kernels account remote traffic at
    ``link_bw * remote_access_efficiency`` instead of migrating."""

    name = "svm_remote"

    def available(self, platform: SimPlatform) -> bool:
        return platform.host_can_access_device and platform.device_can_access_host

    def static_summary(self) -> StrategySummary:
        return StrategySummary(self.name, "remote")

    def on_alloc(self, sim: UMSimulator, step: wk.Alloc) -> None:
        sim.advise_preferred_location(step.name, MemorySpace.HOST)


class UMHybridCountersStrategy(VariantStrategy):
    """Grace-Hopper-style access-counter hybrid (Schieffer et al.): every
    region starts host-pinned and the GPU accesses it remotely over the
    coherent link; per-chunk access counters promote a chunk on its
    ``threshold``-th remote touch, migrating it through the simulator's
    normal fault/copy accounting.  Cold data never migrates (svm_remote
    behaviour), hot data converges to on-demand UM behaviour, and because
    promoted chunks join the normal eviction queues the oversubscription
    cliff returns *gradually* as the hot working set grows — instead of
    never (svm_remote) or immediately (um)."""

    name = "um_hybrid_counters"
    DEFAULT_THRESHOLD = 2.0

    def __init__(self, threshold: float | None = None):
        self.threshold = (self.DEFAULT_THRESHOLD if threshold is None
                          else float(threshold))

    def available(self, platform: SimPlatform) -> bool:
        # access counters ride the coherent fabric (GH C2C, P9 ATS)
        return platform.host_can_access_device and platform.device_can_access_host

    def static_summary(self) -> StrategySummary:
        return StrategySummary(self.name, "hybrid",
                               counter_threshold=self.threshold)

    def on_alloc(self, sim: UMSimulator, step: wk.Alloc) -> None:
        sim.advise_preferred_location(step.name, MemorySpace.HOST)
        sim.enable_access_counters(step.name, self.threshold)


class UMPinnedZeroCopyStrategy(VariantStrategy):
    """Host-pinned zero-copy (``cudaHostAlloc`` semantics): every region is
    pinned host memory the GPU maps directly, so all GPU traffic is remote
    at ``remote_access_efficiency`` — no faults, no migration, no eviction,
    no oversubscription cliff.  The degenerate no-coherence cousin of
    ``svm_remote``: data only ever lives host-side and only the device maps
    the other side's memory, so the gate is ``device_can_access_host``
    alone and the tier exists on plain PCIe platforms."""

    name = "um_pinned_zero_copy"

    def available(self, platform: SimPlatform) -> bool:
        return platform.device_can_access_host

    def static_summary(self) -> StrategySummary:
        return StrategySummary(self.name, "remote")

    def on_alloc(self, sim: UMSimulator, step: wk.Alloc) -> None:
        sim.advise_preferred_location(step.name, MemorySpace.HOST)


class UMAdaptiveAdviseStrategy(UMAdviseStrategy):
    """Thrash-aware graceful degradation of the advise tier (DESIGN.md §12).

    Lowers exactly like ``um_advise`` until the report's rolling thrash
    window (``sim.report.thrash``) shows eviction pressure, then withdraws
    the migration-hostile advises before the next compute step:
    READ_MOSTLY duplication is dropped (the free drop — host copies stay
    valid — that exits the paper's P9 re-duplication fault explosion) and
    PREFERRED_LOCATION(DEVICE) pins are released (stopping the coherent
    fabrics' eager-restore ping-pong).  ACCESSED_BY mappings are kept:
    remote mappings cause no migration and cannot thrash.  The checks only
    *read* counters, so on traces where thrash never triggers the tier is
    bit-identical to ``um_advise`` (tests/test_adaptive_tiers.py pins it).
    """

    name = "um_adaptive_advise"

    def static_summary(self) -> StrategySummary:
        return StrategySummary(self.name, "migrate", issues_advises=True,
                               adaptive=True)

    def before_step(self, sim: UMSimulator, workload: wk.Workload,
                    idx: int, step: wk.ComputeStep) -> None:
        self._shed_hostile_advises(sim)

    def serving_step(self, sim: UMSimulator, names: list[str]) -> None:
        # same trigger, same withdrawal, per decode step: under serving
        # thrash the "keep KV close" pins (serving_admit) are the pathology
        self._shed_hostile_advises(sim)

    @staticmethod
    def _shed_hostile_advises(sim: UMSimulator) -> None:
        if not sim.report.thrash.thrashing():
            return
        for name, r in sim.regions.items():
            if r.read_mostly:
                sim.unadvise_read_mostly(name)
            if r.preferred is MemorySpace.DEVICE:
                sim.unadvise_preferred_location(name)


class UMPrefetchAdaptiveStrategy(UMPrefetchPipelinedStrategy):
    """Thrash-aware pipelined prefetch (DESIGN.md §12): replays the §11
    per-step windows until the report's rolling thrash window shows
    eviction pressure, then *suspends* further windows — under thrash a
    prefetch evicts still-needed data that refaults, so not prefetching
    bounds the damage — and resumes when the window clears (the window
    ages out after ``ThrashWindow.SIZE`` eviction-free launches).  The
    staging-point windows are unconditional: the thrash window is empty
    before the first launch, identical to the base tier.  Bit-identical to
    ``um_prefetch_pipelined`` whenever thrash never triggers."""

    name = "um_prefetch_adaptive"

    def static_summary(self) -> StrategySummary:
        return StrategySummary(self.name, "migrate",
                               prefetch="staged" if self.staged
                               else "pipelined", adaptive=True)

    def before_step(self, sim: UMSimulator, workload: wk.Workload,
                    idx: int, step: wk.ComputeStep) -> None:
        if sim.report.thrash.thrashing():
            return
        super().before_step(sim, workload, idx, step)

    def serving_step(self, sim: UMSimulator, names: list[str]) -> None:
        if sim.report.thrash.thrashing():
            return
        super().serving_step(sim, names)


# -- registry ------------------------------------------------------------------

_REGISTRY: dict[str, VariantStrategy] = {}


def register(strategy: VariantStrategy, *, replace: bool = False) -> VariantStrategy:
    if not strategy.name:
        raise ValueError("strategy needs a non-empty name")
    if strategy.name in _REGISTRY and not replace:
        raise ValueError(f"strategy {strategy.name!r} already registered")
    _REGISTRY[strategy.name] = strategy
    return strategy


def get_strategy(name: str) -> VariantStrategy:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown variant {name!r}; registered: {strategy_names()}") from None


def strategy_names() -> tuple[str, ...]:
    return tuple(_REGISTRY)


for _s in (ExplicitStrategy(), UMStrategy(), UMAdviseStrategy(),
           UMPrefetchStrategy(), UMBothStrategy(), SVMRemoteStrategy(),
           UMHybridCountersStrategy(), UMPinnedZeroCopyStrategy(),
           UMPrefetchPipelinedStrategy(), UMBothPipelinedStrategy(),
           UMAdaptiveAdviseStrategy(), UMPrefetchAdaptiveStrategy()):
    register(_s)
