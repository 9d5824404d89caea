"""umbench harness — the paper's experiment matrix (§III):

  {explicit, um, um_advise, um_prefetch, um_both} (+ the beyond-paper
   svm_remote / um_hybrid_counters / um_pinned_zero_copy tiers and the
   pipelined prefetch schedules um_prefetch_pipelined / um_both_pipelined
   in the extended sweep)
× {in-memory (~80 % device mem), oversubscribed (~150 %), oversubscribed_2x
   (200 %, beyond-paper stress regime)}
× platforms (Intel-Pascal/Volta PCIe, P9-Volta NVLink, Grace-Hopper C2C,
   H100 host model)
× six applications
× chunk granularity ("group" = 2 MB fault groups, the paper's driver block;
   "page" = 64 KB system pages, modelling the coherent-fabric fault
   explosion of Fig. 7c/8c directly).

The variant axis is a real API (DESIGN.md §8): apps are declarative
``Workload`` traces (``umbench.workload``), variants are ``VariantStrategy``
objects resolved through ``umbench.variants``'s registry, and
``run_cell(workload, strategy, platform, regime)`` lowers one onto the
other.  String arguments are resolved through the registries, so the
process pool ships names, not objects.  The pre-redesign string-based entry
points (``APPS`` and per-app ``simulate``-style callables) survive as thin
wrappers over the same path.

Figure of merit: simulated GPU-kernel-time-plus-stalls (the paper's metric)
with the paper's Fig. 4/7 breakdown (compute / fault stall / HtoD / DtoH).

``run_matrix(workers=N)`` fans cells out over a ``concurrent.futures``
process pool — cells are independent simulations, so the sweep scales with
cores; the default stays serial (the vectorized engine already runs the
seed 240-cell matrix in a few seconds).

Robustness (DESIGN.md §12): ``run_cell`` wraps the whole lowering so any
unexpected exception — and any per-cell ``timeout_s`` expiry — surfaces as
a failure record carrying the (workload, strategy, platform, regime) key
instead of an opaque pool traceback; a ``faults=`` scenario attaches a
seeded ``repro_torch.core.faults`` injector.  The pooled sweep isolates worker
crashes (a broken pool is rebuilt and the in-flight cells retried with
bounded exponential backoff; a deterministically crashing cell becomes a
failure record, never a dead sweep), and an optional
``journal.SweepJournal`` checkpoints every completed cell so interrupted
sweeps resume without re-running finished work.
"""
from __future__ import annotations

import dataclasses
import os
import signal
import threading
import time
from concurrent.futures import ProcessPoolExecutor, as_completed
from concurrent.futures.process import BrokenProcessPool
from contextlib import contextmanager
from typing import Callable

from repro_torch.core.simulator import (
    GB,
    OversubscriptionError,
    SimPlatform,
    SimReport,
    UMSimulator,
)
from repro_torch.umbench import platforms as plat
from repro_torch.umbench import variants as var
from repro_torch.umbench.analysis.audit import AuditError
from repro_torch.umbench.apps import bfs, black_scholes, cg, conv_fft, fdtd3d, matmul
from repro_torch.umbench.workload import Workload

VARIANTS = ("explicit", "um", "um_advise", "um_prefetch", "um_both")
# beyond-paper tiers: the SVM remote-access-only tier, the Grace-Hopper
# access-counter hybrid, host-pinned zero-copy for PCIe platforms, the
# capacity-aware pipelined prefetch schedules (DESIGN.md §11), and the
# thrash-aware adaptive tiers that degrade their static bases under
# eviction pressure (DESIGN.md §12)
BEYOND_PAPER_VARIANTS = ("svm_remote", "um_hybrid_counters",
                         "um_pinned_zero_copy", "um_prefetch_pipelined",
                         "um_both_pipelined", "um_adaptive_advise",
                         "um_prefetch_adaptive")
EXTENDED_VARIANTS = VARIANTS + BEYOND_PAPER_VARIANTS
REGIMES = {
    "in_memory": 0.80,
    "oversubscribed": 1.50,
    "oversubscribed_2x": 2.00,   # beyond-paper: 200 % oversubscription
}

# app name -> workload builder: Callable[[total_bytes], Workload]
WORKLOADS: dict[str, Callable[..., Workload]] = {
    "bs": black_scholes.workload,
    "cublas": matmul.workload,
    "cg": cg.workload,
    "graph500": bfs.workload,
    "conv0": conv_fft.make_workload("conv0"),
    "conv1": conv_fft.make_workload("conv1"),
    "conv2": conv_fft.make_workload("conv2"),
    "fdtd3d": fdtd3d.workload,
}


def _legacy_simulate(app: str) -> Callable:
    """The pre-redesign per-app entry point, ``fn(sim, total_bytes, variant)``
    — now a thin wrapper: build the trace, resolve the strategy, lower."""
    def simulate(sim, total_bytes: float, variant: str,
                 iters: int | None = None) -> None:
        build = WORKLOADS[app]
        workload = build(total_bytes) if iters is None else build(total_bytes,
                                                                  iters=iters)
        var.get_strategy(variant).lower(workload, sim)
    simulate.__name__ = f"simulate_{app}"
    return simulate


APPS: dict[str, Callable] = {name: _legacy_simulate(name) for name in WORKLOADS}

DEFAULT_PLATFORMS = ("intel-pascal-pcie", "intel-volta-pcie", "p9-volta-nvlink")
# the seed matrix above, plus the coherent superchip and the stress regime
EXTENDED_PLATFORMS = DEFAULT_PLATFORMS + ("grace-hopper-c2c",)
DEFAULT_REGIMES = ("in_memory", "oversubscribed")
EXTENDED_REGIMES = ("in_memory", "oversubscribed", "oversubscribed_2x")


@dataclasses.dataclass
class CellResult:
    app: str
    platform: str
    variant: str
    regime: str
    report: SimReport | None      # None => N/A (explicit cannot oversubscribe;
    granularity: str = "group"    # remote tiers need their platform gate)
    faults: str | None = None     # fault-scenario name, None = clean run
    error: str | None = None      # per-cell failure record (timeout/crash/
    #                               exception); report is None when set
    error_kind: str | None = None  # analysis tag on the failure: "lint"
    #                                (static findings blocked the run),
    #                                "audit" (AuditError mid-run), or
    #                                "bounds" (measured counters outside
    #                                their provable static bracket); None
    #                                for ordinary timeouts/crashes

    @property
    def total_s(self) -> float | None:
        return None if self.report is None else self.report.total_s

    def row(self) -> dict:
        r = self.report
        # faults/error/injection keys appear only when set, so clean-run
        # rows keep the exact pre-§12 BENCH schema (the committed-artifact
        # diff gate matches on them)
        return {
            "app": self.app,
            "platform": self.platform,
            "variant": self.variant,
            "regime": self.regime,
            "granularity": self.granularity,
            "total_s": None if r is None else round(r.total_s, 4),
            **({} if r is None else {
                "compute_s": round(r.compute_s, 4),
                "fault_stall_s": round(r.fault_stall_s, 4),
                "htod_s": round(r.htod_s, 4),
                "dtoh_s": round(r.dtoh_s, 4),
                "htod_gb": round(r.htod_bytes / GB, 3),
                "dtoh_gb": round(r.dtoh_bytes / GB, 3),
                "remote_gb": round(r.remote_bytes / GB, 3),
                "faults": r.n_faults,
                "evictions": r.n_evictions,
                "promotions": r.n_promotions,
                "promoted_gb": round(r.promoted_bytes / GB, 3),
                "prefetch_copy_s": round(r.prefetch_copy_s, 4),
                "prefetch_wait_s": round(r.prefetch_wait_s, 4),
                "prefetch_overlap_s": round(r.prefetch_overlap_s, 4),
            }),
            **({} if self.faults is None else {"fault_scenario": self.faults}),
            **({} if self.faults is None or r is None else {
                "n_retries": r.n_retries,
                "retry_stall_s": round(r.retry_stall_s, 4),
                "n_degraded_xfers": r.n_degraded_xfers,
                "n_storm_faults": r.n_storm_faults,
            }),
            **({} if self.error is None else {"error": self.error}),
            **({} if self.error_kind is None
               else {"error_kind": self.error_kind}),
        }


class CellTimeout(Exception):
    """A cell exceeded its per-cell wall-clock budget (``timeout_s``)."""


@contextmanager
def _cell_deadline(seconds: float | None):
    """Raise :class:`CellTimeout` inside the block after ``seconds`` of wall
    clock.  SIGALRM-based, so it works inside pool workers (each worker's
    main thread) and interrupts the simulation's pure-Python loops; a
    no-op off the main thread or where SIGALRM does not exist."""
    if (not seconds or not hasattr(signal, "SIGALRM")
            or threading.current_thread() is not threading.main_thread()):
        yield
        return

    def _alarm(signum, frame):
        raise CellTimeout

    old_handler = signal.signal(signal.SIGALRM, _alarm)
    # setitimer returns the PREVIOUS timer (remaining_s, interval_s): an
    # ambient/nested deadline that was already ticking.  Zeroing the timer
    # on exit would silently disarm it — restore it instead, minus the time
    # this block consumed (clamped to "fire asap" when it already expired
    # under us, since our handler swallowed the delivery).
    old_delay, old_interval = signal.setitimer(signal.ITIMER_REAL, seconds)
    t0 = time.monotonic()
    try:
        yield
    finally:
        # disarm OUR timer before swapping handlers back (a late fire must
        # never land on the restored handler), then re-arm the previous one
        signal.setitimer(signal.ITIMER_REAL, 0.0)
        signal.signal(signal.SIGALRM, old_handler)
        if old_delay:
            remaining = old_delay - (time.monotonic() - t0)
            signal.setitimer(signal.ITIMER_REAL, max(remaining, 1e-6),
                             old_interval)


def run_cell(workload: Workload | str, strategy: "var.VariantStrategy | str",
             platform: SimPlatform | str, regime: str,
             granularity: str = "group", faults=None,
             timeout_s: float | None = None, lint: bool = False,
             audit: bool = False, bounds: bool = False) -> CellResult:
    """Run one matrix cell: lower ``workload`` through ``strategy`` onto a
    fresh simulator.  ``workload``/``strategy``/``platform`` accept either
    objects or registry names; a string workload is sized to the regime's
    fraction of the platform's device memory (the paper's working-set rule).

    ``faults`` (scenario name or ``FaultScenario``) attaches a seeded
    fault injector salted with the cell key, so the same cell under the
    same scenario injects identically in every worker (DESIGN.md §12).
    ``lint=True`` statically lints the workload first (DESIGN.md §14) and
    refuses to run a cell with error-severity findings — the findings come
    back as the cell's failure record with ``error_kind="lint"``.
    ``audit=True`` runs the simulator with the engine invariant audit armed;
    an :class:`~repro_torch.umbench.analysis.audit.AuditError` becomes a failure
    record with ``error_kind="audit"``.
    ``bounds=True`` cross-checks a clean report against the cell's static
    transfer bounds (``analysis.bounds``, DESIGN.md §16); a measurement
    outside its provable bracket becomes a failure record with
    ``error_kind="bounds"`` — the engine, not the workload, is the suspect.
    ``timeout_s`` bounds the cell's wall clock.  Registry-resolution errors
    (unknown names) still raise — they are caller bugs — but any failure
    *executing* the cell (timeout included) returns a CellResult carrying
    the cell key and the reason in ``error`` instead of propagating an
    opaque traceback through the pool.
    """
    p = plat.PLATFORMS[platform] if isinstance(platform, str) else platform
    strat = var.get_strategy(strategy) if isinstance(strategy, str) else strategy
    scenario = None
    if faults is not None:
        from repro_torch.core import faults as fl
        scenario = fl.get_scenario(faults)
    if isinstance(workload, str):
        total = REGIMES[regime] * p.device_mem_gb * GB
        workload = WORKLOADS[workload](total)
    fname = None if scenario is None else scenario.name
    if not strat.available(p):
        return CellResult(workload.name, p.name, strat.name, regime, None,
                          granularity, fname)
    if lint:
        from repro_torch.umbench.analysis import lint_workload
        errs = [f for f in lint_workload(
                    workload, capacity=int(p.device_mem_gb * GB),
                    expect_oversubscription=(regime != "in_memory"))
                if f.severity == "error"]
        if errs:
            return CellResult(workload.name, p.name, strat.name, regime,
                              None, granularity, fname,
                              "; ".join(str(f) for f in errs), "lint")
    sim = UMSimulator(p, granularity=granularity, audit=audit)
    if scenario is not None and scenario.enabled():
        salt = (f"{workload.name}:{p.name}:{strat.name}:{regime}:"
                f"{granularity}")
        sim.set_fault_injector(fl.FaultInjector(scenario, salt))
    error = None
    error_kind = None
    try:
        with _cell_deadline(timeout_s):
            strat.lower(workload, sim)
            report = sim.finish()
    except OversubscriptionError:
        report = None  # the paper: 'the case does not exist with explicit'
    except CellTimeout:
        report = None
        error = f"timeout after {timeout_s}s"
    except AuditError as e:
        report = None
        error = str(e)
        error_kind = "audit"
    except Exception as e:  # noqa: BLE001 — the per-cell failure record
        report = None
        error = f"{type(e).__name__}: {e}"
    if bounds and report is not None and scenario is None:
        from repro_torch.umbench.analysis.bounds import workload_bounds
        b = workload_bounds(workload, strat, p, granularity)
        errs = (["cell has a report but bounds say N/A"] if b is None
                else b.check(report))
        if errs:
            report = None
            error = "bounds: " + "; ".join(errs)
            error_kind = "bounds"
    return CellResult(workload.name, p.name, strat.name, regime, report,
                      granularity, fname, error, error_kind)


def _spec_fields(spec: tuple) -> tuple:
    """Normalize a 5- or 7-tuple spec to names:
    (app, platform, variant, regime, granularity, faults, timeout_s)."""
    app, pname, variant, regime, granularity = spec[:5]
    faults = spec[5] if len(spec) > 5 else None
    timeout_s = spec[6] if len(spec) > 6 else None
    return (getattr(app, "name", app), getattr(pname, "name", pname),
            getattr(variant, "name", variant), regime, granularity,
            getattr(faults, "name", faults), timeout_s)


def _spec_key(spec: tuple) -> tuple:
    """Journal identity of a spec (mirrors ``journal.cell_key``)."""
    return _spec_fields(spec)[:6]


def _failure_cell(spec: tuple, reason: str) -> CellResult:
    app, pname, vname, regime, granularity, fname, _ = _spec_fields(spec)
    return CellResult(app, pname, vname, regime, None, granularity, fname,
                      reason)


def bounds_failure(cell: CellResult) -> CellResult | None:
    """The standard matrix-cell ``verify=`` hook for :func:`run_specs`:
    cross-check a clean cell against its static transfer bounds
    (``analysis.bounds.verify_cell``) and return a replacement
    ``error_kind="bounds"`` failure record when the measurement falls
    outside its provable bracket — None when the cell passes (or is not
    checkable: failure records, N/A cells, fault-injected cells)."""
    from repro_torch.umbench.analysis.bounds import verify_cell
    errs = verify_cell(cell)
    if not errs:
        return None
    return CellResult(cell.app, cell.platform, cell.variant, cell.regime,
                      None, cell.granularity, cell.faults,
                      "bounds: " + "; ".join(errs), "bounds")


def _run_cell_spec(spec: tuple) -> CellResult:
    """Top-level (picklable) cell runner for the process pool.  ``variant``
    may be a registry name or a VariantStrategy object — run_matrix resolves
    names to objects before pooling so runtime-registered strategies survive
    spawn-based workers (which re-import the registry's built-ins only).
    Accepts the legacy 5-tuple or the 7-tuple with (faults, timeout_s)."""
    app, pname, variant, regime, granularity = spec[:5]
    faults = spec[5] if len(spec) > 5 else None
    timeout_s = spec[6] if len(spec) > 6 else None
    return run_cell(app, variant, pname, regime, granularity,
                    faults=faults, timeout_s=timeout_s)


def matrix_specs(apps=None, platform_names=DEFAULT_PLATFORMS,
                 regimes=DEFAULT_REGIMES, variants=VARIANTS,
                 granularity: str = "group") -> list[tuple]:
    apps = apps or list(WORKLOADS)
    return [
        (app, pname, variant, regime, granularity)
        for regime in regimes
        for pname in platform_names
        for app in apps
        for variant in variants
    ]


def _run_spec_batch(args: tuple) -> list:
    """Top-level (picklable) batch runner: one pool task runs a group of
    cells sharing (platform, regime, granularity) back-to-back, amortizing
    per-task dispatch/IPC over the group (DESIGN.md §15).  Cells stay
    independent — the runner builds a fresh simulator per cell — so the
    batch's results are field-for-field the per-cell path's."""
    runner, specs = args
    return [runner(s) for s in specs]


# cells per pool task: big enough to amortize dispatch, small enough that a
# long-tail cell cannot serialize the sweep behind its batch-mates
BATCH_MAX = 8


def _plan_batches(pending: list[int], specs: dict[int, tuple],
                  workers: int) -> list[list[int]]:
    """Group pending spec indices by (platform, regime, granularity) — the
    axes that shape simulator state — and chunk each group so every worker
    sees several batches (load balance beats amortization at the tail)."""
    groups: dict[tuple, list[int]] = {}
    for i in pending:
        s = specs[i]
        groups.setdefault((s[1], s[3], s[4]), []).append(i)
    per_task = max(1, min(BATCH_MAX,
                          -(-len(pending) // max(1, workers * 4))))
    batches: list[list[int]] = []
    for group in groups.values():
        batches.extend(group[k:k + per_task]
                       for k in range(0, len(group), per_task))
    return batches


def run_specs(specs: list[tuple], workers: int | None = None,
              retries: int = 2, retry_backoff_s: float = 0.5,
              journal=None, runner=None, failure=None,
              cache=None, fingerprint=None, verify=None) -> list[CellResult]:
    """Run a list of cell specs (5- or 7-tuples, see ``_run_cell_spec``),
    returning results in spec order.

    ``runner``/``failure`` plug a different cell family into the same
    robust sweep: ``runner(spec) -> cell`` (top-level, picklable — the
    default is ``_run_cell_spec``) and ``failure(spec, reason) -> cell``
    build that family's results; the serving sweep
    (``umbench.serving.sweep``) reuses pooling, retry, and journaling this
    way, with specs of the same positional shape.

    The robust sweep core (DESIGN.md §12): cells already present in
    ``journal`` (a ``journal.SweepJournal``) are replayed from disk
    instead of re-run; fresh results are journaled as they complete.  With
    ``workers`` > 1 the cells fan out over a process pool in batches
    grouped by (platform, regime, granularity) — one pool task runs a
    whole batch, amortizing dispatch/IPC (DESIGN.md §15) — and a worker
    crash breaks only that pool generation: the casualties are retried up
    to ``retries`` times *in isolation* (one cell per single-worker pool,
    after exponential backoff), so a deterministically crashing cell takes
    the blame alone and becomes a failure record while its innocent
    batch-mates succeed on their first isolated retry.  In-cell exceptions
    and timeouts never reach this layer — ``run_cell`` already converts
    them to failure records.

    ``cache`` (a ``cellcache.CellCache``) adds the content-addressed layer
    (DESIGN.md §15) *after* the journal: journal replay keeps its resume
    semantics, cache hits answer cells whose inputs and engine are
    unchanged, and fresh results (plus journal replays) are recorded back.
    ``fingerprint(spec) -> str`` computes the input hash — the default is
    the matrix-cell ``cellcache.spec_fingerprint``.

    ``verify(cell) -> CellResult | None`` cross-checks every result on the
    parent side — fresh runs, journal replays, and cache hits alike, so a
    replayed cell is re-verified for free.  A non-None return *replaces*
    the cell (the hook demotes it to a failure record, e.g.
    :func:`bounds_failure`'s ``error_kind="bounds"``); replacements are
    journaled and never cached (the cache drops error records), so a
    resumed sweep retries them.
    """
    runner = _run_cell_spec if runner is None else runner
    failure = _failure_cell if failure is None else failure
    if cache is not None and fingerprint is None:
        from repro_torch.umbench.cellcache import spec_fingerprint
        fingerprint = spec_fingerprint

    def _verified(cell: CellResult) -> CellResult:
        if verify is None:
            return cell
        bad = verify(cell)
        return cell if bad is None else bad

    results: dict[int, CellResult] = {}
    pending: list[int] = []
    fps: dict[int, str] = {}
    for i, s in enumerate(specs):
        if cache is not None:
            fps[i] = fingerprint(s)
        cached = journal.lookup(_spec_key(s)) if journal is not None else None
        if cached is not None:
            results[i] = _verified(cached)
            if cache is not None:
                cache.record(results[i], fps[i])  # converge cache on resume
            continue
        if cache is not None:
            hit = cache.lookup(_spec_key(s), fps[i])
            if hit is not None:
                results[i] = _verified(hit)
                continue
        pending.append(i)

    def _done(i: int, cell: CellResult) -> None:
        cell = _verified(cell)
        results[i] = cell
        if journal is not None:
            journal.ran += 1
            journal.record(cell)
        if cache is not None:
            cache.record(cell, fps[i])

    if pending and workers is not None and workers > 1:
        def _resolve(s: tuple) -> tuple:
            # resolve strategy names to objects so runtime-registered
            # strategies survive spawn-based workers
            v = var.get_strategy(s[2]) if isinstance(s[2], str) else s[2]
            return (s[0], s[1], v, *s[3:])
        rspecs = {i: _resolve(specs[i]) for i in pending}
        attempts = dict.fromkeys(pending, 0)
        round_no = 0
        while pending:
            crashed: list[int] = []
            if round_no == 0:
                batches = _plan_batches(pending, rspecs, workers)
                with ProcessPoolExecutor(max_workers=workers) as pool:
                    futs = {}
                    try:
                        for b in batches:
                            task = (runner, tuple(rspecs[i] for i in b))
                            futs[pool.submit(_run_spec_batch, task)] = b
                    except BrokenProcessPool:
                        pass        # pool died mid-submit: the unsubmitted
                    #                 cells fall through to `crashed` below
                    submitted = {i for b in futs.values() for i in b}
                    crashed.extend(i for i in pending if i not in submitted)
                    for fut in as_completed(futs):
                        b = futs[fut]
                        try:
                            cells = fut.result()
                        except BrokenProcessPool:
                            crashed.extend(b)
                            continue
                        except Exception as e:  # noqa: BLE001 — unpicklable
                            cells = [failure(rspecs[i],
                                             f"{type(e).__name__}: {e}")
                                     for i in b]
                        for i, cell in zip(b, cells, strict=True):
                            _done(i, cell)
            else:
                # retry casualties one per single-worker pool: a cell that
                # crashes deterministically must not keep taking innocent
                # pool-mates down with it
                for i in pending:
                    with ProcessPoolExecutor(max_workers=1) as pool:
                        try:
                            cell = pool.submit(runner, rspecs[i]).result()
                        except BrokenProcessPool:
                            crashed.append(i)
                            continue
                        except Exception as e:  # noqa: BLE001
                            cell = failure(rspecs[i],
                                           f"{type(e).__name__}: {e}")
                    _done(i, cell)
            pending = []
            for i in crashed:
                attempts[i] += 1
                if attempts[i] > retries:
                    _done(i, failure(
                        rspecs[i],
                        f"worker crashed ({attempts[i]} attempts)"))
                else:
                    pending.append(i)
            if pending:
                time.sleep(retry_backoff_s * (2 ** round_no))
                round_no += 1
    else:
        for i in pending:
            _done(i, runner(specs[i]))
    return [results[i] for i in range(len(specs))]


def run_matrix(apps=None, platform_names=DEFAULT_PLATFORMS,
               regimes=DEFAULT_REGIMES, variants=VARIANTS,
               granularity: str = "group",
               workers: int | None = None, faults=None,
               cell_timeout_s: float | None = None,
               retries: int = 2, retry_backoff_s: float = 0.5,
               journal=None, cache=None, verify=None) -> list[CellResult]:
    """Run the experiment matrix; ``workers`` > 1 fans the independent cells
    out over a process pool (cells are returned in matrix order either way).
    ``faults``/``cell_timeout_s``/``retries``/``journal`` plug in the §12
    robustness layer, ``cache`` the §15 content-addressed cell cache — see
    ``run_specs``."""
    specs = matrix_specs(apps, platform_names, regimes, variants, granularity)
    if faults is not None or cell_timeout_s is not None:
        # FaultScenario objects ride the spec as-is (picklable frozen
        # dataclass); _spec_key reduces them to their name
        specs = [s + (faults, cell_timeout_s) for s in specs]
    return run_specs(specs, workers=workers, retries=retries,
                     retry_backoff_s=retry_backoff_s, journal=journal,
                     cache=cache, verify=verify)


def run_extended_matrix(workers: int | None = None,
                        granularity: str = "group",
                        journal=None, cache=None,
                        verify=None) -> list[CellResult]:
    """The seed matrix plus the Grace-Hopper platform, the 200 % regime, and
    the beyond-paper variant tiers (svm_remote and um_hybrid_counters are
    N/A on platforms without a coherent fabric; um_pinned_zero_copy needs
    only ``device_can_access_host``)."""
    return run_matrix(platform_names=EXTENDED_PLATFORMS,
                      regimes=EXTENDED_REGIMES,
                      variants=EXTENDED_VARIANTS,
                      granularity=granularity, workers=workers,
                      journal=journal, cache=cache, verify=verify)


def run_page_matrix(workers: int | None = None,
                    journal=None, cache=None, verify=None) -> list[CellResult]:
    """The full extended matrix at 64 KB system-page granularity — the
    regime where fault counts explode (Fig. 7c/8c) and where chunk state is
    ~400k-1.5M pages per region on 96 GB platforms.  Routinely runnable
    since the incremental residency index / run-coalescing rewrite
    (DESIGN.md §9); wall time is tracked in BENCH_umbench.json."""
    return run_extended_matrix(workers=workers, granularity="page",
                               journal=journal, cache=cache, verify=verify)


def default_workers() -> int:
    return max(1, os.cpu_count() or 1)


def speedup_vs_um(results: list[CellResult]) -> dict[tuple, float]:
    """(app, platform, regime, variant, granularity)
    -> total_time(um) / total_time(variant).

    The baseline is the ``um`` cell of the SAME granularity — a mixed
    group+page result list (e.g. a concatenated extended+page sweep) must
    never divide a page-mode cell by a group-mode baseline.  Cells with no
    report (N/A) and cells whose baseline ``um`` total is missing or zero
    are skipped."""
    base = {
        (r.app, r.platform, r.regime, r.granularity): r.total_s
        for r in results if r.variant == "um" and r.total_s
    }
    out = {}
    for r in results:
        if not r.total_s:       # N/A (None) or degenerate zero-total cells
            continue
        key = (r.app, r.platform, r.regime, r.granularity)
        if key in base:
            out[(r.app, r.platform, r.regime, r.variant,
                 r.granularity)] = base[key] / r.total_s
    return out
