"""umlint — static dataflow analysis over workload traces (DESIGN.md §14).

:func:`lint_workload` walks a :class:`~repro_torch.umbench.workload.Workload`'s
step lists *without executing the simulator*: allocations, host I/O, kernel
read/write sets, frees, and the advise/prefetch hints are compiled to a
linear event stream and checked against the rule catalog below.
:func:`lint_ops` runs the same dataflow core over a recorded op stream
(``umbench.analysis.trace`` records one from a live serving scheduler), so
traces that have no static Workload — the serving tier's request-driven
region lifecycle — lint through the identical rules.

Rules (the table is pinned against DESIGN.md §14 by
tests/test_docs_consistency.py; every rule has a purpose-built bad fixture
in tests/test_analysis_lint.py and zero findings across the builtin apps):

========  ========  =====================================================
rule      severity  meaning
========  ========  =====================================================
UML001    error     use of a region before (or without) its allocation
UML002    error     use of a region after its free
UML003    error     double free
UML004    warning   dead region: never touched by any kernel
UML005    warning   dead advise: READ_MOSTLY / PREFERRED_LOCATION hint on
                    a region no kernel touches after the hint
                    (ACCESSED_BY is exempt — remote mappings also serve
                    host I/O)
UML006    warning   per-step prefetch list names a region outside the
                    workload's prefetch pool
UML007    error     prefetch candidate freed before its anchored window
                    (the ``schedule.derive_plan`` drop — see §11)
UML008    warning   PRE_INIT advise on a region never host-written during
                    setup (the anchor is meaningless; use POST_INIT)
UML009    warning   oversubscription-unreachable: the cell expects
                    eviction pressure but peak live bytes fit in device
                    memory
UML010    warning   staged prefetch window provably exceeds device
                    capacity at its anchor (self-evicting; the pipelined
                    schedule clamps, so it is exempt)
UML011    warning   advise hint provably dead under the platform/strategy
                    gate table (ACCESSED_BY(DEVICE) is never consulted;
                    ACCESSED_BY(HOST) needs host_can_access_device;
                    PREFERRED_LOCATION(HOST) needs device_can_access_host)
========  ========  =====================================================

UML010/UML011 ride the same abstract gate tables as ``analysis.bounds``
and need cell context — they arm only when ``strategy=``/``platform=``
are passed (the builtin-app sweep lints workloads without a cell, so they
stay quiet there).

Severities: ``error`` findings describe traces the engine will reject or
mis-serve (KeyErrors, wasted copies); ``warning`` findings describe dead
weight or cells that cannot measure what they claim.  The reference's CLI
(``python -m repro.umbench.analysis``) fails on errors, and on warnings
too under ``--strict``; the port's comes with its serving sweep.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.advise import Advise
from repro_torch.umbench import workload as wk

__all__ = ["Finding", "RULES", "lint_ops", "lint_workload"]

#: rule id -> (severity, one-line description); the docs table mirrors this
RULES: dict[str, tuple[str, str]] = {
    "UML001": ("error", "use of a region before (or without) its allocation"),
    "UML002": ("error", "use of a region after its free"),
    "UML003": ("error", "double free"),
    "UML004": ("warning", "dead region: never touched by any kernel"),
    "UML005": ("warning", "dead advise: hint on a region no kernel touches "
                          "after it (ACCESSED_BY exempt)"),
    "UML006": ("warning", "per-step prefetch list names a region outside "
                          "the workload prefetch pool"),
    "UML007": ("error", "prefetch candidate freed before its anchored "
                        "window (the derive_plan drop)"),
    "UML008": ("warning", "PRE_INIT advise on a region never host-written "
                          "during setup"),
    "UML009": ("warning", "oversubscription-unreachable: peak live bytes "
                          "fit in device memory"),
    "UML010": ("warning", "staged prefetch window provably exceeds device "
                          "capacity at its anchor (self-evicting)"),
    "UML011": ("warning", "advise hint provably dead under the "
                          "platform/strategy gate table"),
}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One linter (or contract-checker) finding.

    ``step_idx`` indexes the flattened trace (setup + compute + teardown)
    for workload lints, the op stream for recorded-trace lints; -1 marks
    trace-level findings with no single anchoring step."""

    rule_id: str
    severity: str
    step_idx: int
    region: str | None
    message: str

    def __str__(self) -> str:
        at = "" if self.step_idx < 0 else f" @ step {self.step_idx}"
        return f"{self.rule_id} [{self.severity}]{at}: {self.message}"


def _finding(rule: str, idx: int, region: str | None, msg: str) -> Finding:
    return Finding(rule, RULES[rule][0], idx, region, msg)


# -- the dataflow core ---------------------------------------------------------
#
# Events are (step_idx, tuple) pairs; the tuple vocabulary:
#
#   ("alloc", name, nbytes)          region comes to life
#   ("free", name)                   region lifetime ends
#   ("kernel", kname, reads, writes) one launch with its touch sets
#   ("advise", name, kind[, detail]) kind in {"read_mostly",
#                                    "preferred_location", "accessed_by"};
#                                    detail (optional, for the gate rules)
#                                    is the MemorySpace/Accessor name
#                                    ("DEVICE"/"HOST") — 3-tuples from
#                                    older recorders still lint
#   ("prefetch", name)               an explicit prefetch call
#   ("use", name, label)             any other region reference (host I/O,
#                                    unadvise, counters, explicit staging)

class _Dataflow:
    def __init__(self):
        self.findings: list[Finding] = []
        self.allocated: dict[str, int] = {}       # name -> nbytes
        self.freed: set[str] = set()
        self.first_alloc: dict[str, int] = {}     # name -> first alloc idx
        self.kernel_touched: set[str] = set()
        # advise hints not yet followed by a kernel touch of their region:
        # name -> [(idx, kind), ...]
        self.pending_advise: dict[str, list[tuple[int, str]]] = {}
        self.live_bytes = 0
        self.peak_bytes = 0

    def _ref(self, idx: int, name: str, what: str) -> bool:
        """Region-reference check; False when the reference is invalid."""
        if name in self.allocated:
            return True
        if name in self.freed:
            self.findings.append(_finding(
                "UML002", idx, name, f"{what} of {name!r} after its free"))
        else:
            self.findings.append(_finding(
                "UML001", idx, name,
                f"{what} of {name!r}, which is never allocated at this "
                f"point"))
        return False

    def event(self, idx: int, ev: tuple) -> None:
        op = ev[0]
        if op == "alloc":
            _, name, nbytes = ev
            self.freed.discard(name)
            self.allocated[name] = int(nbytes)
            self.first_alloc.setdefault(name, idx)
            self.live_bytes += int(nbytes)
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        elif op == "free":
            _, name = ev
            if name in self.allocated:
                self.live_bytes -= self.allocated.pop(name)
                self.freed.add(name)
            elif name in self.freed:
                self.findings.append(_finding(
                    "UML003", idx, name, f"double free of {name!r}"))
            else:
                self._ref(idx, name, "free")
        elif op == "kernel":
            _, kname, reads, writes = ev
            for name in dict.fromkeys(tuple(reads) + tuple(writes)):
                if self._ref(idx, name, f"kernel {kname!r} access"):
                    self.kernel_touched.add(name)
                    self.pending_advise.pop(name, None)
        elif op == "advise":
            name, kind = ev[1], ev[2]
            if self._ref(idx, name, f"{kind} advise") and kind in (
                    "read_mostly", "preferred_location"):
                self.pending_advise.setdefault(name, []).append((idx, kind))
        elif op == "prefetch":
            _, name = ev
            self._ref(idx, name, "prefetch")
        else:
            _, name, label = ev
            self._ref(idx, name, label)

    def finish(self, *, capacity: int | None,
               expect_oversubscription: bool) -> list[Finding]:
        for name, idx in sorted(self.first_alloc.items(),
                                key=lambda kv: kv[1]):
            if name not in self.kernel_touched:
                self.findings.append(_finding(
                    "UML004", idx, name,
                    f"region {name!r} is never touched by any kernel"))
        for name, hints in self.pending_advise.items():
            for idx, kind in hints:
                self.findings.append(_finding(
                    "UML005", idx, name,
                    f"{kind} advise on {name!r} with no kernel touch of it "
                    f"afterwards"))
        if expect_oversubscription and capacity is not None \
                and self.peak_bytes <= capacity:
            self.findings.append(_finding(
                "UML009", -1, None,
                f"cell expects oversubscription but peak live bytes "
                f"({self.peak_bytes}) fit device memory ({capacity})"))
        return sorted(self.findings, key=lambda f: (max(f.step_idx, 0),
                                                    f.rule_id,
                                                    f.region or ""))


# -- the context-armed gate rules (UML010/UML011) ------------------------------

def _resolve_cell(strategy, platform):
    """(StrategySummary, SimPlatform) from names or objects; (None, None)
    components when the corresponding context was not provided."""
    summary = None
    if strategy is not None:
        from repro_torch.umbench import variants as var
        strat = (var.get_strategy(strategy) if isinstance(strategy, str)
                 else strategy)
        summary = strat.static_summary()
    p = None
    if platform is not None:
        from repro_torch.umbench import platforms as plat
        p = plat.PLATFORMS[platform] if isinstance(platform, str) else platform
    return summary, p


def _dead_advise_findings(events, summary, p) -> list[Finding]:
    """UML011: advise hints the engine provably never honors on this cell —
    read straight off the simulator's gate table.  ACCESSED_BY(DEVICE) has
    no consumer at all (only ``Accessor.HOST`` is consulted, by the host
    I/O remote path); ACCESSED_BY(HOST) needs ``host_can_access_device``;
    PREFERRED_LOCATION(HOST)'s remote-read path needs
    ``device_can_access_host``.  Detail-less 3-tuple advise events carry no
    space/accessor, so they are never flagged."""
    out: list[Finding] = []
    if p is None or (summary is not None and not summary.issues_advises):
        # a non-advising strategy never issues the hints: nothing to check
        # (lint_workload still reports them as pending via UML005)
        return out
    for idx, ev in events:
        if ev[0] != "advise" or len(ev) < 4 or ev[3] is None:
            continue
        name, kind, detail = ev[1], ev[2], ev[3]
        if kind == "accessed_by":
            if detail == "DEVICE":
                out.append(_finding(
                    "UML011", idx, name,
                    f"ACCESSED_BY(DEVICE) advise on {name!r}: the engine "
                    f"never consults device accessors — the hint is dead "
                    f"on every platform"))
            elif detail == "HOST" and not p.host_can_access_device:
                out.append(_finding(
                    "UML011", idx, name,
                    f"ACCESSED_BY(HOST) advise on {name!r} is dead on "
                    f"{p.name}: the remote host-I/O path needs "
                    f"host_can_access_device"))
        elif (kind == "preferred_location" and detail == "HOST"
              and not p.device_can_access_host):
            out.append(_finding(
                "UML011", idx, name,
                f"PREFERRED_LOCATION(HOST) advise on {name!r} is dead on "
                f"{p.name}: the device remote-read path needs "
                f"device_can_access_host"))
    return out


def _staged_window_findings(workload: wk.Workload, summary, p,
                            capacity: int | None,
                            granularity: str) -> list[Finding]:
    """UML010: the staged schedule copies the whole prefetch pool at the
    staging anchor; if the pool's ceil-chunk bytes exceed device capacity
    the window provably self-evicts (the pipelined schedule derives clamped
    windows via ``schedule.derive_plan``, so only ``prefetch == "staged"``
    strategies are flagged)."""
    if summary is None or summary.prefetch != "staged":
        return []
    if capacity is None:
        if p is None:
            return []
        from repro_torch.core.simulator import GB
        capacity = int(p.device_mem_gb * GB)
    chunk = 2 * 1024 * 1024
    if p is not None:
        chunk = (p.page_bytes if granularity == "page"
                 else p.fault_group_bytes)
    sizes = {s.name: s.nbytes for s in workload.setup
             if isinstance(s, wk.Alloc)}
    pool = [n for n in workload.prefetch if n in sizes]
    pool_bytes = sum(max(1, -(-int(sizes[n]) // chunk)) * chunk
                     for n in pool)
    if pool_bytes <= capacity:
        return []
    anchor = len(workload.setup)
    return [_finding(
        "UML010", anchor, None,
        f"staged prefetch pool {sorted(pool)} is {pool_bytes} ceil-chunk "
        f"bytes at its anchor, exceeding device capacity ({capacity}) — "
        f"the window provably self-evicts; use the pipelined schedule")]


# -- entry points --------------------------------------------------------------

def lint_ops(ops, *, capacity: int | None = None,
             expect_oversubscription: bool = False,
             strategy=None, platform=None) -> list[Finding]:
    """Lint a recorded op stream (see the event vocabulary above);
    ``step_idx`` in the findings is the op's stream position.
    ``strategy``/``platform`` (names or objects) arm the context-dependent
    gate rule UML011 — without them only the context-free rules run."""
    df = _Dataflow()
    for idx, ev in enumerate(ops):
        df.event(idx, ev)
    findings = df.finish(capacity=capacity,
                         expect_oversubscription=expect_oversubscription)
    summary, p = _resolve_cell(strategy, platform)
    findings.extend(_dead_advise_findings(enumerate(ops), summary, p))
    return sorted(findings, key=lambda f: (max(f.step_idx, 0), f.rule_id,
                                           f.region or ""))


_ADVISE_KIND = {
    Advise.READ_MOSTLY: "read_mostly",
    Advise.PREFERRED_LOCATION: "preferred_location",
    Advise.ACCESSED_BY: "accessed_by",
}


def _advise_detail(directive) -> str | None:
    """The gate-rule detail of an advise directive: the MemorySpace /
    Accessor name ("DEVICE"/"HOST"), None for READ_MOSTLY."""
    if directive.advise is Advise.PREFERRED_LOCATION:
        return directive.location.name
    if directive.advise is Advise.ACCESSED_BY:
        return directive.accessor.name
    return None


def _compile(workload: wk.Workload) -> list[tuple[int, tuple]]:
    """Lower a Workload to the dataflow event stream, mirroring the variant
    lowering template's order: PRE_INIT hints fire right after their
    region's allocation (the earliest the template can issue them),
    POST_INIT hints at the staging point between setup and compute."""
    pre = {h.name: [] for h in workload.advises_at(wk.PRE_INIT)}
    for h in workload.advises_at(wk.PRE_INIT):
        pre[h.name].append(h)
    events: list[tuple[int, tuple]] = []
    idx = 0
    for step in workload.setup:
        if isinstance(step, wk.Alloc):
            events.append((idx, ("alloc", step.name, step.nbytes)))
            for h in pre.pop(step.name, ()):
                events.append((idx, ("advise", step.name,
                                     _ADVISE_KIND[h.directive.advise],
                                     _advise_detail(h.directive))))
        else:
            events.append((idx, ("use", step.name, "host write")))
        idx += 1
    # PRE_INIT hints on never-allocated regions still reference them
    for name, hints in pre.items():
        for h in hints:
            events.append((-1, ("advise", name,
                                _ADVISE_KIND[h.directive.advise],
                                _advise_detail(h.directive))))
    staging = idx          # the staging point carries the setup-end index
    for h in workload.advises_at(wk.POST_INIT):
        events.append((staging, ("advise", h.name,
                                 _ADVISE_KIND[h.directive.advise],
                                 _advise_detail(h.directive))))
    for name in workload.prefetch:
        events.append((staging, ("prefetch", name)))
    for step in workload.compute:
        if isinstance(step, wk.KernelStep):
            events.append((idx, ("kernel", step.name, step.reads,
                                 step.writes)))
        elif isinstance(step, wk.Free):
            events.append((idx, ("free", step.name)))
        elif isinstance(step, wk.HostWrite):
            events.append((idx, ("use", step.name, "host write")))
        elif isinstance(step, wk.ReadBack):
            events.append((idx, ("use", step.name, "readback")))
        else:
            events.append((idx, ("use", step.name, "host read")))
        idx += 1
    for step in workload.teardown:
        label = "readback" if isinstance(step, wk.ReadBack) else "host read"
        events.append((idx, ("use", step.name, label)))
        idx += 1
    return events


def _structural(workload: wk.Workload) -> list[Finding]:
    """The workload-only rules: per-step prefetch hygiene (UML006/UML007)
    and PRE_INIT anchoring (UML008)."""
    findings: list[Finding] = []
    setup_len = len(workload.setup)
    pool = set(workload.prefetch)
    freed_at: dict[str, int] = {}
    for ci, s in enumerate(workload.compute):
        if isinstance(s, wk.Free) and s.name not in freed_at:
            freed_at[s.name] = ci
    for ci, s in enumerate(workload.compute):
        if not isinstance(s, wk.KernelStep):
            continue
        idx = setup_len + ci
        for name in s.prefetch:
            if name not in pool:
                findings.append(_finding(
                    "UML006", idx, name,
                    f"kernel {s.name!r} lists prefetch candidate {name!r} "
                    f"outside the workload pool {sorted(pool)}"))
        for name in s.prefetch_candidates(workload.prefetch):
            if freed_at.get(name, 1 << 62) < ci:
                findings.append(_finding(
                    "UML007", idx, name,
                    f"kernel {s.name!r} prefetch candidate {name!r} is "
                    f"freed at compute step {freed_at[name]}, before this "
                    f"step — derive_plan drops it (DESIGN.md §11)"))
    written = set(workload.host_written())
    for h in workload.advises_at(wk.PRE_INIT):
        if h.name not in written:
            findings.append(_finding(
                "UML008", -1, h.name,
                f"PRE_INIT {_ADVISE_KIND[h.directive.advise]} advise on "
                f"{h.name!r}, which setup never host-writes — the "
                f"pre-initialization anchor is meaningless"))
    return findings


def lint_workload(workload: wk.Workload, *, capacity: int | None = None,
                  expect_oversubscription: bool = False,
                  strategy=None, platform=None,
                  granularity: str = "group") -> list[Finding]:
    """Lint one workload trace.  ``capacity`` (device bytes) plus
    ``expect_oversubscription=True`` arms UML009 for cells whose regime
    claims eviction pressure.  ``strategy``/``platform`` (names or
    objects) arm the context-dependent gate rules UML010/UML011 for one
    concrete cell; ``granularity`` sizes UML010's chunk rounding."""
    df = _Dataflow()
    events = _compile(workload)
    for idx, ev in events:
        df.event(idx, ev)
    findings = df.finish(capacity=capacity,
                         expect_oversubscription=expect_oversubscription)
    findings.extend(_structural(workload))
    summary, p = _resolve_cell(strategy, platform)
    findings.extend(_dead_advise_findings(events, summary, p))
    findings.extend(_staged_window_findings(workload, summary, p, capacity,
                                            granularity))
    return sorted(findings, key=lambda f: (max(f.step_idx, 0), f.rule_id,
                                           f.region or ""))
