"""Declarative workload traces — "what the app does", with zero variant logic.

The paper's experiment matrix is {variant} x {regime} x {platform} x {app},
but in the pre-redesign code the *variant* axis was not an axis: every app
under ``umbench/apps/`` re-implemented the explicit/um_advise/um_prefetch
lowering as inline ``if variant == ...`` blocks against the simulator's
imperative API.  This module makes the app side purely declarative:

* a :class:`Workload` is an ordered trace of allocation, host-I/O, and
  kernel steps plus *hints* (advise directives, prefetch candidates) that a
  memory-variant strategy may or may not honour;
* each app module builds one via :class:`WorkloadBuilder` and never touches
  a simulator;
* ``umbench.variants`` lowers a Workload onto a simulator — advise
  placement, prefetch insertion and explicit-copy staging each live in
  exactly one strategy class (DESIGN.md §8).

Step ordering is semantic: the simulator's residency order (LRU stamps) and
the coherent-fabric remote-initialization path depend on the exact order of
allocations, host writes and advises, so a Workload preserves the trace
order instead of normalizing it.  Advise hints carry a ``when`` anchor:

* ``PRE_INIT``  — issued before the first host write (e.g. CG pins the
  matrix to device memory so host initialization writes remotely through
  the fabric — the paper's P9 in-memory win, §IV-A);
* ``POST_INIT`` — issued at the staging point between initialization and
  the first kernel (e.g. READ_MOSTLY after the host stops writing).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Mapping

from repro_torch.core.advise import (
    Accessor,
    Advise,
    AdviseDirective,
    MemorySpace,
    set_accessed_by,
    set_preferred_location,
    set_read_mostly,
)

PRE_INIT = "pre_init"
POST_INIT = "post_init"


# -- trace steps ---------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Alloc:
    """One managed allocation (cudaMallocManaged)."""

    name: str
    nbytes: int
    role: str = "data"


@dataclasses.dataclass(frozen=True)
class HostWrite:
    """Host writes ``nbytes`` of the region (None = the whole region)."""

    name: str
    nbytes: int | None = None


@dataclasses.dataclass(frozen=True)
class HostRead:
    """Host reads the region — in *every* variant (e.g. CG's residual check
    reads ``x`` through UM even in the explicit build)."""

    name: str
    nbytes: int | None = None


@dataclasses.dataclass(frozen=True)
class ReadBack:
    """Result readback, lowered per variant: an explicit build issues a
    cudaMemcpy DtoH; UM builds fault/remote-read the pages back."""

    name: str


@dataclasses.dataclass(frozen=True)
class Free:
    """Release a managed allocation mid-trace (cudaFree on a managed
    pointer).  A compute-phase step: serving traces and phased apps free
    regions whose lifetime ends before the trace does, handing their
    device residency back to the pool.  Lifetime *semantics* (no
    use-after-free, no double-free) are the trace linter's job
    (``umbench.analysis.lint``), not ``Workload.validate`` — so linter
    fixtures for those rules remain constructible."""

    name: str


@dataclasses.dataclass(frozen=True)
class KernelStep:
    """One GPU kernel launch with its read/write sets.

    ``partial`` maps region name -> fraction in (0, 1] touched this launch
    (data-dependent access, e.g. a BFS frontier sweep); stored as an items
    tuple so the step stays hashable.

    ``prefetch`` optionally names this step's prefetch candidates for the
    pipelined scheduler (DESIGN.md §11).  Empty means "derive from the read
    set": the scheduler uses the step's reads+writes intersected with the
    workload-level ``prefetch`` candidate list, in access order.
    """

    name: str
    flops: float
    reads: tuple[str, ...]
    writes: tuple[str, ...]
    bytes_touched: float | None = None
    partial: tuple[tuple[str, float], ...] = ()
    prefetch: tuple[str, ...] = ()

    def partial_map(self) -> dict[str, float] | None:
        return dict(self.partial) if self.partial else None

    def prefetch_candidates(self, pool: tuple[str, ...]) -> tuple[str, ...]:
        """This step's prefetch candidates: the explicit per-step list, or
        the read-set-derived default — touched regions that are in the
        workload-level candidate ``pool``, in access order, deduplicated."""
        if self.prefetch:
            return self.prefetch
        allowed = set(pool)
        seen: list[str] = []
        for n in self.reads + self.writes:
            if n in allowed and n not in seen:
                seen.append(n)
        return tuple(seen)


@dataclasses.dataclass(frozen=True)
class AdviseHint:
    """One advise directive on one named allocation, with its anchor point.

    A hint, not a command: only advise-bearing strategies issue it."""

    name: str
    directive: AdviseDirective
    when: str = POST_INIT

    def __post_init__(self):
        if self.when not in (PRE_INIT, POST_INIT):
            raise ValueError(f"when must be {PRE_INIT!r} or {POST_INIT!r}")


SetupStep = Alloc | HostWrite
ComputeStep = KernelStep | HostWrite | HostRead | ReadBack | Free
TeardownStep = ReadBack | HostRead


# -- the trace -----------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Workload:
    """A declarative app trace: setup (allocations + host initialization),
    compute (kernel launches), teardown (result readback) — plus the advise
    and prefetch hints a variant strategy may honour."""

    name: str
    setup: tuple[SetupStep, ...]
    compute: tuple[ComputeStep, ...]
    teardown: tuple[TeardownStep, ...]
    advises: tuple[AdviseHint, ...] = ()
    prefetch: tuple[str, ...] = ()
    # how many kernel steps ahead the pipelined scheduler may stage a
    # step's candidates (DESIGN.md §11); 1 = overlap with the previous
    # step's compute only
    prefetch_lookahead: int = 1

    def allocs(self) -> tuple[Alloc, ...]:
        return tuple(s for s in self.setup if isinstance(s, Alloc))

    def host_written(self) -> tuple[str, ...]:
        """Names host-initialized during setup, in first-write order — the
        explicit variant's HtoD staging list."""
        seen: list[str] = []
        for s in self.setup:
            if isinstance(s, HostWrite) and s.name not in seen:
                seen.append(s.name)
        return tuple(seen)

    def device_only(self) -> tuple[str, ...]:
        """Allocations never host-initialized (outputs/workspaces), in
        allocation order — the explicit variant's cudaMalloc list."""
        written = set(self.host_written())
        return tuple(a.name for a in self.allocs() if a.name not in written)

    def advises_at(self, when: str) -> tuple[AdviseHint, ...]:
        return tuple(h for h in self.advises if h.when == when)

    def validate(self) -> "Workload":
        # phase membership first (hand-built Workloads bypass the builder):
        # a misfiled step would otherwise lower as the wrong simulator call
        for phase, steps, allowed in (
            ("setup", self.setup, (Alloc, HostWrite)),
            ("compute", self.compute,
             (KernelStep, HostWrite, HostRead, ReadBack, Free)),
            ("teardown", self.teardown, (ReadBack, HostRead)),
        ):
            for s in steps:
                if not isinstance(s, allowed):
                    raise ValueError(
                        f"{self.name}: {type(s).__name__} not allowed in "
                        f"{phase} phase")
        names = [a.name for a in self.allocs()]
        dup = {n for n in names if names.count(n) > 1}
        if dup:
            raise ValueError(f"{self.name}: duplicate allocations {sorted(dup)}")
        # setup is walked in order: a host write before its region's Alloc
        # would KeyError inside the simulator — fail loudly here instead
        so_far: set[str] = set()
        for s in self.setup:
            if isinstance(s, Alloc):
                so_far.add(s.name)
            elif s.name not in so_far:
                raise ValueError(
                    f"{self.name}: HostWrite({s.name!r}) before its Alloc")
        known = set(names)

        def check(kind: str, used: Iterable[str]) -> None:
            missing = [n for n in used if n not in known]
            if missing:
                raise ValueError(
                    f"{self.name}: {kind} references unallocated {missing}")

        for s in self.setup + self.compute + self.teardown:
            if isinstance(s, KernelStep):
                check(f"kernel {s.name}", s.reads + s.writes
                      + tuple(n for n, _ in s.partial) + s.prefetch)
            elif isinstance(s, (HostWrite, HostRead, ReadBack, Free)):
                check(type(s).__name__, (s.name,))
        check("prefetch", self.prefetch)
        check("advise", (h.name for h in self.advises))
        if self.prefetch_lookahead < 1:
            raise ValueError(
                f"{self.name}: prefetch_lookahead must be >= 1, got "
                f"{self.prefetch_lookahead}")
        return self


class WorkloadBuilder:
    """Fluent trace recorder.  Steps are recorded in call order; ``build()``
    splits the trace into setup / compute / teardown phases:

    * setup    = everything before the first kernel launch,
    * teardown = the maximal trailing run of readback/host-read steps,
    * compute  = the middle.

    Allocations after the first kernel are rejected — strategies stage
    (explicit copies, advises, prefetches) exactly once, between setup and
    compute, so late allocations would silently miss staging.
    """

    def __init__(self, name: str):
        self.name = name
        self._steps: list = []
        self._advises: list[AdviseHint] = []
        self._prefetch: list[str] = []
        self._lookahead = 1
        self._saw_kernel = False

    # -- trace steps -----------------------------------------------------------
    def alloc(self, name: str, nbytes: int, role: str = "data") -> "WorkloadBuilder":
        if self._saw_kernel:
            raise ValueError(f"{self.name}: alloc({name!r}) after first kernel")
        self._steps.append(Alloc(name, int(nbytes), role))
        return self

    def host_write(self, name: str, nbytes: int | None = None) -> "WorkloadBuilder":
        self._steps.append(HostWrite(name, nbytes))
        return self

    def host_read(self, name: str, nbytes: int | None = None) -> "WorkloadBuilder":
        self._steps.append(HostRead(name, nbytes))
        return self

    def readback(self, name: str) -> "WorkloadBuilder":
        self._steps.append(ReadBack(name))
        return self

    def free(self, name: str) -> "WorkloadBuilder":
        """Release ``name`` mid-compute; only legal after the first kernel
        (``build()`` files pre-kernel steps into setup, which rejects it)."""
        self._steps.append(Free(name))
        return self

    def kernel(self, name: str, *, flops: float, reads: Iterable[str],
               writes: Iterable[str], bytes_touched: float | None = None,
               partial: Mapping[str, float] | None = None,
               prefetch: Iterable[str] | None = None) -> "WorkloadBuilder":
        self._saw_kernel = True
        self._steps.append(KernelStep(
            name, float(flops), tuple(reads), tuple(writes), bytes_touched,
            tuple((partial or {}).items()), tuple(prefetch or ())))
        return self

    # -- hints -----------------------------------------------------------------
    def advise_read_mostly(self, name: str,
                           when: str = POST_INIT) -> "WorkloadBuilder":
        self._advises.append(AdviseHint(name, set_read_mostly(), when))
        return self

    def advise_preferred_location(self, name: str, space: MemorySpace,
                                  when: str = POST_INIT) -> "WorkloadBuilder":
        self._advises.append(AdviseHint(name, set_preferred_location(space), when))
        return self

    def advise_accessed_by(self, name: str, accessor: Accessor,
                           when: str = POST_INIT) -> "WorkloadBuilder":
        self._advises.append(AdviseHint(name, set_accessed_by(accessor), when))
        return self

    def prefetch(self, *names: str) -> "WorkloadBuilder":
        self._prefetch.extend(names)
        return self

    def prefetch_lookahead(self, depth: int) -> "WorkloadBuilder":
        """Pipelined-scheduler lookahead: a kernel step's candidates may be
        staged up to ``depth`` kernel steps ahead of their use."""
        self._lookahead = int(depth)
        return self

    # -- assembly --------------------------------------------------------------
    def build(self) -> Workload:
        first_kernel = next(
            (i for i, s in enumerate(self._steps) if isinstance(s, KernelStep)),
            len(self._steps))
        tail = len(self._steps)
        while tail > first_kernel and isinstance(
                self._steps[tail - 1], (ReadBack, HostRead)):
            tail -= 1
        setup = self._steps[:first_kernel]
        bad = [s for s in setup if not isinstance(s, (Alloc, HostWrite))]
        if bad:
            raise ValueError(f"{self.name}: {bad[0]} before first kernel")
        return Workload(
            name=self.name,
            setup=tuple(setup),
            compute=tuple(self._steps[first_kernel:tail]),
            teardown=tuple(self._steps[tail:]),
            advises=tuple(self._advises),
            prefetch=tuple(self._prefetch),
            prefetch_lookahead=self._lookahead,
        ).validate()


__all__ = [
    "PRE_INIT", "POST_INIT",
    "Alloc", "HostWrite", "HostRead", "ReadBack", "Free", "KernelStep",
    "AdviseHint",
    "Workload", "WorkloadBuilder",
    "Accessor", "Advise", "MemorySpace",
]
