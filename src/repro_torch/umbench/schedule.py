"""Capacity-aware pipelined prefetch scheduling (DESIGN.md §11).

The paper's `cudaMemPrefetchAsync` variant (§II-C) stages *everything* in
one monolithic bulk copy at the staging point.  In-memory that is already
near-optimal; under the 150 %/200 % regimes the staged prefetch
**self-evicts** — the tail of the bulk copy evicts the head before the
first kernel ever runs, so the kernel refaults data the copy stream just
moved (the failure mode the oversubscription-management literature
schedules around; PAPERS.md: *An Intelligent Framework for Oversubscription
Management in CPU-GPU Unified Memory*, *Deep Learning based Data
Prefetching in CPU-GPU Unified Virtual Memory*).

This module turns the prefetch *schedule* into a first-class artifact:

* :func:`derive_plan` walks a :class:`~repro_torch.umbench.workload.Workload`'s
  compute trace and derives per-kernel-step **prefetch windows** that never
  exceed free-plus-safely-evictable capacity — a window must not plan an
  eviction of bytes a nearer kernel step still reads;
* the result is a :class:`PrefetchPlan` — ``(anchor, items)`` windows the
  variant strategy replays on the simulator's existing async copy stream
  (``UMSimulator.prefetch(name, nbytes=...)``), so window copies overlap
  the *previous* step's compute;
* :func:`staged_plan` is the degenerate schedule — one window covering the
  whole candidate list at the staging point — and is the mechanism's
  correctness oracle: lowering it is bit-identical to the ``um_prefetch``
  variant (tests/test_prefetch_schedule.py pins this across the full seed
  matrix), so the scheduler needs zero new seed-model code.

The planner is *static*: it models residency in planned bytes per region
(insertion order approximating the simulator's FIFO-LRU), not per chunk.
Byte cuts always land on chunk boundaries via the region's run-byte cumsum
(a region is one uniform-chunk-size run plus a tail — the same closed-form
cut the §9 eviction planner uses), so a window never asks the simulator to
copy a fraction of a chunk and the capacity bound survives the simulator's
ceil-to-chunk rounding.  Divergence between the static model and the
simulator's actual residency (partial kernels, advise placement) only
costs schedule *quality*, never correctness — unplanned data simply faults
on demand, exactly as under plain ``um``.
"""
from __future__ import annotations

import dataclasses
import functools

from repro_torch.umbench import workload as wk

#: window anchor meaning "the staging point" (between setup and compute)
STAGING = -1


@dataclasses.dataclass(frozen=True)
class PrefetchItem:
    """One prefetch call: region ``name`` up to cumulative byte limit
    ``nbytes`` from the region start (None = the whole region)."""

    name: str
    nbytes: int | None = None


@dataclasses.dataclass(frozen=True)
class PrefetchWindow:
    """Items issued together, immediately before compute step ``anchor``
    (``STAGING`` = at the staging point, before the first compute step)."""

    anchor: int
    items: tuple[PrefetchItem, ...]

    def total_bytes(self, sizes: dict[str, int]) -> int:
        return sum(sizes[i.name] if i.nbytes is None else i.nbytes
                   for i in self.items)


@dataclasses.dataclass(frozen=True)
class PrefetchPlan:
    """An ordered set of prefetch windows over one workload trace."""

    windows: tuple[PrefetchWindow, ...]

    def at(self, anchor: int) -> tuple[PrefetchItem, ...]:
        out: tuple[PrefetchItem, ...] = ()
        for w in self.windows:
            if w.anchor == anchor:
                out = out + w.items
        return out

    def issue(self, sim, anchor: int) -> None:
        """Replay this plan's windows for ``anchor`` on the simulator's
        async copy stream."""
        for item in self.at(anchor):
            sim.prefetch(item.name, nbytes=item.nbytes)

    def anchors(self) -> tuple[int, ...]:
        return tuple(w.anchor for w in self.windows)


@functools.lru_cache(maxsize=256)
def staged_plan(workload: wk.Workload) -> PrefetchPlan:
    """The degenerate schedule: one window, at the staging point, covering
    the workload's whole candidate list in declared order — exactly what
    ``um_prefetch`` lowers, expressed as a plan (the mechanism oracle)."""
    if not workload.prefetch:
        return PrefetchPlan(())
    items = tuple(PrefetchItem(nm) for nm in workload.prefetch)
    return PrefetchPlan((PrefetchWindow(STAGING, items),))


class _Planner:
    """Static residency model: planned resident bytes per region, insertion
    order approximating the simulator's FIFO-LRU queues."""

    def __init__(self, capacity: int, chunk_bytes: int,
                 sizes: dict[str, int]):
        self.capacity = int(capacity)
        self.chunk = int(chunk_bytes)
        self.sizes = sizes
        self.resident: dict[str, int] = {}      # name -> planned bytes

    def used(self) -> int:
        return sum(self.resident.values())

    def _chunk_floor(self, nbytes: int) -> int:
        """Largest whole-chunk byte count <= nbytes — the run-byte-cumsum
        cut of a uniform run (§9 arithmetic, closed form)."""
        return (nbytes // self.chunk) * self.chunk

    def evictable(self, protected: set[str]) -> int:
        return sum(b for n, b in self.resident.items() if n not in protected)

    def _evict(self, amount: int, protected: set[str]) -> None:
        """Drain unprotected planned-resident bytes in insertion order (the
        simulator pops its queues oldest-first) until ``amount`` is freed."""
        freed = 0
        for n in list(self.resident):
            if freed >= amount:
                break
            if n in protected:
                continue
            take = min(self.resident[n], amount - freed)
            self.resident[n] -= take
            freed += take
            if self.resident[n] <= 0:
                del self.resident[n]

    def admit(self, name: str, protected: set[str]) -> int:
        """Plan bringing ``name`` device-resident within the capacity bound:
        never more than free + evictable-outside-``protected`` bytes, cut at
        a chunk boundary.  Returns the newly planned bytes (0 = nothing
        affordable)."""
        have = self.resident.get(name, 0)
        need = self.sizes[name] - have
        if need <= 0:
            # LRU touch: move to the back of the planner's queue
            self.resident[name] = self.resident.pop(name)
            return 0
        free = self.capacity - self.used()
        budget = free + self.evictable(protected | {name})
        take = min(need, self._chunk_floor(budget))
        if take <= 0:
            return 0
        if take > free:
            self._evict(take - free, protected | {name})
        self.resident[name] = have + take
        self.resident[name] = self.resident.pop(name)   # file at the tail
        return take


def _kernel_steps(workload: wk.Workload) -> list[tuple[int, wk.KernelStep]]:
    return [(i, s) for i, s in enumerate(workload.compute)
            if isinstance(s, wk.KernelStep)]


def _touched(step: wk.KernelStep) -> tuple[str, ...]:
    seen: list[str] = []
    for n in step.reads + step.writes:
        if n not in seen:
            seen.append(n)
    return tuple(seen)


@functools.lru_cache(maxsize=256)
def derive_plan(workload: wk.Workload, capacity: int, chunk_bytes: int,
                lookahead: int | None = None) -> PrefetchPlan:
    """Derive the capacity-aware pipelined schedule for one workload on a
    device with ``capacity`` bytes and ``chunk_bytes`` migration chunks.

    Kernel ordinal ``j``'s candidates (``KernelStep.prefetch_candidates``)
    are planned into the window anchored ``lookahead`` kernel steps
    earlier — at the staging point for the first ``lookahead`` kernels — so
    each window's copies overlap the anchor step's compute and arrive just
    before use.  Window growth is bounded by
    ``free + safely-evictable`` planned capacity, where bytes needed by any
    kernel step between the window's anchor and its target are *protected*
    (never planned for eviction); the cut lands on a chunk boundary via the
    region's run-byte cumsum.  Candidates that do not fit are simply left
    to fault on demand — the schedule degrades toward ``um``, never toward
    self-eviction.
    """
    ks = _kernel_steps(workload)
    if not ks or not workload.prefetch:
        return PrefetchPlan(())
    d = max(1, int(lookahead if lookahead is not None
                   else workload.prefetch_lookahead))
    sizes = {a.name: a.nbytes for a in workload.allocs()}
    planner = _Planner(capacity, chunk_bytes, sizes)
    windows: dict[int, list[PrefetchItem]] = {}
    executed = 0            # kernels the static model has replayed
    # first Free per region (compute index): a candidate freed before its
    # using kernel step must never be planned — by issue time the region
    # name is gone from the simulator (sim.prefetch would KeyError) or the
    # copy is pure waste, freed before the kernel reads it.  Reachable now
    # that serving-style traces mix Free steps with the pipelined tiers;
    # lint rule UML007 cross-references this drop.
    freed_at: dict[str, int] = {}
    for ci, s in enumerate(workload.compute):
        if isinstance(s, wk.Free) and s.name not in freed_at:
            freed_at[s.name] = ci

    def run_kernel(i: int) -> None:
        step = ks[i][1]
        own = set(_touched(step))
        for n in _touched(step):
            planner.admit(n, own)

    for j, (_, step) in enumerate(ks):
        a = j - d           # anchor kernel ordinal (< 0 => staging point)
        while executed < max(a, 0):
            run_kernel(executed)
            executed += 1
        anchor = STAGING if a < 0 else ks[a][0]
        if freed_at and a >= 0:
            # frees with compute index < the anchor step have executed by
            # the time this window is issued: their planned bytes are gone
            for n in [n for n in planner.resident
                      if freed_at.get(n, 1 << 62) < ks[a][0]]:
                del planner.resident[n]
        # bytes any kernel step between anchor and target still reads must
        # not be planned for eviction by this window
        protected = set()
        for i in range(max(a, 0), j + 1):
            protected.update(_touched(ks[i][1]))
        for name in step.prefetch_candidates(workload.prefetch):
            if freed_at.get(name, 1 << 62) < ks[j][0]:
                continue
            took = planner.admit(name, protected)
            if took <= 0:
                continue
            limit = planner.resident[name]
            items = windows.setdefault(anchor, [])
            items.append(PrefetchItem(
                name, None if limit >= sizes[name] else limit))
    return PrefetchPlan(tuple(
        PrefetchWindow(anchor, tuple(items))
        for anchor, items in sorted(
            windows.items(), key=lambda kv: (kv[0] != STAGING, kv[0]))))


__all__ = [
    "STAGING", "PrefetchItem", "PrefetchWindow", "PrefetchPlan",
    "staged_plan", "derive_plan",
]
