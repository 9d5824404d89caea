"""Per-request latency metrics for the serving tier (DESIGN.md §13): the
port's copy of ``repro.umbench.serving.metrics``.

TTFT (arrival to end-of-prefill) and end-to-end latency are derived from
the scheduler's :class:`~repro_torch.umbench.serving.scheduler.ServedRequest`
timelines — simulated device-stream seconds, so queueing delay, prefill
compute, and every fault/migration/eviction stall the UM tier pays land in
the percentiles.  ``goodput_rps`` is completed requests over the trace
makespan (first arrival to last completion); ``tokens_per_s`` counts
decoded tokens over the same span.

:class:`ServingReport` nests the simulator's :class:`SimReport`, serializes
at full precision (``to_json_dict``/``from_json_dict``), and compares by
``==`` field-for-field — the sweep journal round-trips it bit-identically,
exactly like matrix cells.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

from repro_torch.core.simulator import SimReport
from repro_torch.umbench.serving.scheduler import ServedRequest

__all__ = ["ServingReport", "percentile", "summarize"]


def percentile(values: Sequence[float], q: float) -> float:
    """Linear-interpolation percentile (``q`` in [0, 100]) — a deterministic
    pure-Python reimplementation so serving metrics never depend on numpy
    version behaviour.  Empty input returns 0.0."""
    if not values:
        return 0.0
    s = sorted(values)
    if len(s) == 1:
        return float(s[0])
    pos = (q / 100.0) * (len(s) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(s) - 1)
    return float(s[lo] + (s[hi] - s[lo]) * (pos - lo))


@dataclasses.dataclass
class ServingReport:
    """Aggregated serving metrics for one trace, plus the underlying sim
    report (whose ``total_s`` is the cell's BENCH-diffable total)."""

    pattern: str
    arch: str
    n_requests: int = 0
    completed: int = 0
    n_decode_steps: int = 0
    makespan_s: float = 0.0
    goodput_rps: float = 0.0
    tokens_per_s: float = 0.0
    ttft_p50_s: float = 0.0
    ttft_p95_s: float = 0.0
    ttft_p99_s: float = 0.0
    e2e_p50_s: float = 0.0
    e2e_p95_s: float = 0.0
    e2e_p99_s: float = 0.0
    queue_p50_s: float = 0.0
    queue_p99_s: float = 0.0
    sim: SimReport = dataclasses.field(default_factory=SimReport)

    @property
    def total_s(self) -> float:
        return self.sim.total_s

    def to_json_dict(self) -> dict:
        return dataclasses.asdict(self)   # recurses into ``sim``

    @classmethod
    def from_json_dict(cls, d: Mapping) -> "ServingReport":
        d = dict(d)
        sim = SimReport.from_json_dict(d.pop("sim", {}))
        known = {f.name for f in dataclasses.fields(cls)} - {"sim"}
        return cls(sim=sim, **{k: v for k, v in d.items() if k in known})


def summarize(pattern: str, arch: str, served: Sequence[ServedRequest],
              n_requests: int, n_decode_steps: int,
              sim_report: SimReport) -> ServingReport:
    """Fold one trace's request timelines into a :class:`ServingReport`."""
    ttft = [r.prefill_done_s - r.arrival_s for r in served]
    e2e = [r.finish_s - r.arrival_s for r in served]
    queue = [r.admit_s - r.arrival_s for r in served]
    rep = ServingReport(pattern=pattern, arch=arch, n_requests=n_requests,
                        completed=len(served), n_decode_steps=n_decode_steps,
                        sim=sim_report)
    if served:
        t0 = min(r.arrival_s for r in served)
        t1 = max(r.finish_s for r in served)
        rep.makespan_s = t1 - t0
        if rep.makespan_s > 0:
            rep.goodput_rps = len(served) / rep.makespan_s
            rep.tokens_per_s = sum(r.gen_len for r in served) / rep.makespan_s
        rep.ttft_p50_s = percentile(ttft, 50)
        rep.ttft_p95_s = percentile(ttft, 95)
        rep.ttft_p99_s = percentile(ttft, 99)
        rep.e2e_p50_s = percentile(e2e, 50)
        rep.e2e_p95_s = percentile(e2e, 95)
        rep.e2e_p99_s = percentile(e2e, 99)
        rep.queue_p50_s = percentile(queue, 50)
        rep.queue_p99_s = percentile(queue, 99)
    return rep
