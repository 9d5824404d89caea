"""The serving sweep: traffic pattern x variant tier x KV-oversubscription
regime (x optional fault scenario), journaled and resumable (DESIGN.md §13).
The port's copy of ``repro.umbench.serving.sweep``.

Serving cells ride the same machinery as matrix cells: specs are the
harness's (app, platform, variant, regime, granularity[, faults[,
timeout_s]]) tuples with ``serve_<pattern>`` as the app label and the
``kv_100``/``kv_150``/``kv_200`` regimes, pooled through
``harness.run_specs`` (worker-crash isolation, bounded retry) with this
module's cell runner plugged in, and checkpointed through
``journal.SweepJournal`` — a :class:`ServingCellResult` declares
``journal_kind = "serving"`` so the journal reconstructs it (with its
:class:`~repro_torch.umbench.serving.metrics.ServingReport`) on resume.

Determinism: the traffic generator and the fault injector are both salted
with the cell key, so the same cell produces bit-identical metrics in every
process — and a journal-replayed cell equals a re-run one exactly.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.simulator import GB, OversubscriptionError, UMSimulator
from repro_torch.umbench import platforms as plat
from repro_torch.umbench import variants as var
from repro_torch.umbench.analysis.audit import AuditError
from repro_torch.umbench.harness import CellTimeout, _cell_deadline, run_specs
from repro_torch.umbench.serving.metrics import ServingReport, summarize
from repro_torch.umbench.serving.scheduler import ServingConfig, serve
from repro_torch.umbench.serving.traffic import get_pattern

__all__ = [
    "SERVING_REGIMES",
    "ServingCellResult",
    "run_serving_cell",
    "run_serving_specs",
    "serving_specs",
]

# aggregate-KV budget as a fraction of (device memory - weights shard):
# at-capacity, and the paper's two oversubscription stress points
SERVING_REGIMES = {
    "kv_100": 1.00,
    "kv_150": 1.50,
    "kv_200": 2.00,
}


@dataclasses.dataclass
class ServingCellResult:
    """One serving sweep cell — CellResult's shape (same key fields, same
    failure-record contract) carrying a :class:`ServingReport`."""

    app: str                        # "serve_<pattern>"
    platform: str
    variant: str
    regime: str                     # kv_100 | kv_150 | kv_200
    report: ServingReport | None    # None => N/A (platform gate / explicit)
    granularity: str = "group"
    faults: str | None = None
    error: str | None = None
    error_kind: str | None = None   # "audit" when an AuditError fired

    journal_kind = "serving"        # SweepJournal record tag

    @property
    def total_s(self) -> float | None:
        return None if self.report is None else self.report.total_s

    def row(self) -> dict:
        r = self.report
        return {
            "app": self.app,
            "platform": self.platform,
            "variant": self.variant,
            "regime": self.regime,
            "granularity": self.granularity,
            "total_s": None if r is None else round(r.total_s, 4),
            **({} if r is None else {
                "completed": r.completed,
                "goodput_rps": round(r.goodput_rps, 4),
                "tokens_per_s": round(r.tokens_per_s, 2),
                "ttft_p50_s": round(r.ttft_p50_s, 4),
                "ttft_p99_s": round(r.ttft_p99_s, 4),
                "e2e_p50_s": round(r.e2e_p50_s, 4),
                "e2e_p99_s": round(r.e2e_p99_s, 4),
                "htod_gb": round(r.sim.htod_bytes / GB, 3),
                "dtoh_gb": round(r.sim.dtoh_bytes / GB, 3),
                "remote_gb": round(r.sim.remote_bytes / GB, 3),
                "faults": r.sim.n_faults,
                "evictions": r.sim.n_evictions,
            }),
            **({} if self.faults is None else {"fault_scenario": self.faults}),
            **({} if self.error is None else {"error": self.error}),
            **({} if self.error_kind is None
               else {"error_kind": self.error_kind}),
        }


def run_serving_cell(pattern, strategy, platform, regime: str,
                     granularity: str = "group", faults=None,
                     timeout_s: float | None = None,
                     config: ServingConfig | None = None,
                     audit: bool = False,
                     bounds: bool = False) -> ServingCellResult:
    """Run one serving cell: generate the (cell-salted) trace, drive the
    continuous-batching scheduler through ``strategy`` on a fresh simulator,
    and aggregate per-request metrics.  Mirrors ``harness.run_cell``'s
    contract: registry names or objects, N/A on the platform gate and on
    explicit-under-oversubscription, failure records for timeouts and
    in-cell exceptions; ``audit=True`` arms the engine invariant audit
    (failures tagged ``error_kind="audit"``).

    ``bounds=True`` records the scheduler's op stream in-cell (a
    ``analysis.trace.RecordingSim`` wrap — the recorded run stays
    bit-identical) and cross-checks the clean report's transfer counters
    against the stream's static bounds (``analysis.bounds.ops_bounds``,
    DESIGN.md §16); a measurement outside its provable bracket becomes an
    ``error_kind="bounds"`` failure record."""
    p = plat.PLATFORMS[platform] if isinstance(platform, str) else platform
    strat = (var.get_strategy(strategy) if isinstance(strategy, str)
             else strategy)
    pat = get_pattern(pattern)
    app = f"serve_{pat.name}"
    kv_frac = SERVING_REGIMES[regime]
    scenario = None
    if faults is not None:
        from repro_torch.core import faults as fl
        scenario = fl.get_scenario(faults)
    fname = None if scenario is None else scenario.name
    if not strat.available(p):
        return ServingCellResult(app, p.name, strat.name, regime, None,
                                 granularity, fname)
    cfg = config or ServingConfig()
    sim = UMSimulator(p, granularity=granularity, audit=audit)
    salt = f"{app}:{p.name}:{strat.name}:{regime}:{granularity}"
    if scenario is not None and scenario.enabled():
        sim.set_fault_injector(fl.FaultInjector(scenario, salt))
    requests = pat.generate(salt=salt)
    rec = None
    driven = sim
    if bounds and scenario is None:
        from repro_torch.umbench.analysis.trace import RecordingSim
        rec = RecordingSim(sim)
        driven = rec
    error = None
    error_kind = None
    try:
        with _cell_deadline(timeout_s):
            sched = serve(driven, strat, requests, kv_frac, cfg)
            report = summarize(pat.name, cfg.arch, sched.served,
                               len(requests), sched.n_decode_steps,
                               sim.finish())
    except OversubscriptionError:
        report = None   # explicit cannot hold the live KV: N/A, not an error
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
    if rec is not None and report is not None:
        from repro_torch.umbench.analysis.bounds import ops_bounds
        b = ops_bounds(rec.ops, strat, p, granularity)
        errs = (["cell has a report but bounds say N/A"] if b is None
                else b.check(report.sim))
        if errs:
            report = None
            error = "bounds: " + "; ".join(errs)
            error_kind = "bounds"
    return ServingCellResult(app, p.name, strat.name, regime, report,
                             granularity, fname, error, error_kind)


def _run_serving_cell_spec(spec: tuple) -> ServingCellResult:
    """Top-level (picklable) serving-cell runner for the process pool —
    the serving counterpart of ``harness._run_cell_spec``."""
    app, pname, variant, regime, granularity = spec[:5]
    faults = spec[5] if len(spec) > 5 else None
    timeout_s = spec[6] if len(spec) > 6 else None
    return run_serving_cell(app, variant, pname, regime, granularity,
                            faults=faults, timeout_s=timeout_s)


def _run_serving_cell_spec_bounds(spec: tuple) -> ServingCellResult:
    """The bounds-checking runner (``run_serving_specs(bounds=True)``):
    in-worker op recording + static cross-check, so the verification rides
    the pool instead of serializing on the parent."""
    app, pname, variant, regime, granularity = spec[:5]
    faults = spec[5] if len(spec) > 5 else None
    timeout_s = spec[6] if len(spec) > 6 else None
    return run_serving_cell(app, variant, pname, regime, granularity,
                            faults=faults, timeout_s=timeout_s, bounds=True)


def _serving_failure_cell(spec: tuple, reason: str) -> ServingCellResult:
    from repro_torch.umbench.harness import _spec_fields
    app, pname, vname, regime, granularity, fname, _ = _spec_fields(spec)
    return ServingCellResult(app, pname, vname, regime, None, granularity,
                             fname, reason)


def serving_specs(patterns, platform_names, regimes,
                  variants=None, granularity: str = "group",
                  faults=None) -> list[tuple]:
    """Harness-shaped specs for a serving sub-sweep (app =
    ``serve_<pattern>``); ``variants`` defaults to the full registry."""
    variants = variants or var.strategy_names()
    specs = [
        (f"serve_{get_pattern(pat).name}", pname, variant, regime, granularity)
        for regime in regimes
        for pname in platform_names
        for pat in patterns
        for variant in variants
    ]
    if faults is not None:
        specs = [s + (faults,) for s in specs]
    return specs


def run_serving_specs(specs: list[tuple], workers: int | None = None,
                      retries: int = 2, retry_backoff_s: float = 0.5,
                      journal=None, cache=None,
                      bounds: bool = False) -> list[ServingCellResult]:
    """``harness.run_specs`` with the serving runner plugged in: same
    journaling, worker-crash isolation, retry, and cell-cache semantics
    (the serving input fingerprint hashes the cell-salted request trace).
    ``bounds=True`` swaps in the bounds-checking runner — fresh cells are
    statically cross-checked in-worker (see ``run_serving_cell``)."""
    from repro_torch.umbench.cellcache import serving_spec_fingerprint
    runner = (_run_serving_cell_spec_bounds if bounds
              else _run_serving_cell_spec)
    return run_specs(specs, workers=workers, retries=retries,
                     retry_backoff_s=retry_backoff_s, journal=journal,
                     runner=runner,
                     failure=_serving_failure_cell,
                     cache=cache, fingerprint=serving_spec_fingerprint)
