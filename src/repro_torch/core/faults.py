"""Deterministic fault injection for the UM simulator (DESIGN.md §12): the
port's copy of ``repro.core.faults``, whose draws it repeats for the same
scenario and cell key.

The paper's sharpest negative result is a *robustness* failure: statically
chosen memory advises backfire at runtime (P9 oversubscribed, Fig. 7c/8c).
To evaluate policies under hostile conditions — and to trust the adaptive
tiers' numbers — the engine needs a failure model.  This module provides
one, with three injectable pathologies:

  * **degraded-interconnect windows**: the link drops to a fraction of its
    bandwidth for a window of transfer events (a congested fabric, a
    throttled PCIe switch);
  * **transient migration failures**: a transfer event fails and is retried
    with exponential backoff — each failed attempt re-sends the data and
    the backoff latency lands on the issuing stream (ECC retry storms,
    driver-level migration retries);
  * **fault-storm amplification**: fault-group events multiply for a window
    of fault batches (TLB-shootdown storms, the driver's heuristics
    thrashing), amplifying both the stall time and the fault count.

Determinism: a :class:`FaultInjector` draws from ``random.Random`` seeded
by ``(scenario.seed, salt)`` where the salt is the cell key — the same cell
under the same scenario injects the same faults on every run, in every
worker process, regardless of pool scheduling (the draw order is the
simulator's own event order, which is deterministic).  PYTHONHASHSEED does
not enter: the salt is mixed via blake2s, not ``hash()``.

Off-parity: the simulator holds no injector by default (``sim._inj is
None``) and every injection site is behind that guard, so a disabled
injector is not "a scenario with zero probabilities" — it is the absence
of the object, and the engine is bit-identical to the pre-injection code
path (tests/test_faults.py pins the full seed matrix).
"""
from __future__ import annotations

import dataclasses
import hashlib
import random

__all__ = [
    "FaultInjector",
    "FaultScenario",
    "SCENARIOS",
    "get_scenario",
    "scenario_names",
]


@dataclasses.dataclass(frozen=True)
class FaultScenario:
    """One named, seeded failure model.  All probabilities are per *event*
    (one batched simulator call: a fault batch's HtoD, an eviction batch's
    DtoH, one bulk-copy run, one host-I/O migration), not per chunk —
    page-granularity sweeps see the same number of draws as group sweeps
    for the same trace shape, so scenarios stay comparable across the
    granularity axis."""

    name: str
    seed: int = 0
    # degraded-interconnect bandwidth windows
    degrade_prob: float = 0.0       # P(window opens | transfer event, idle)
    degrade_factor: float = 1.0     # bandwidth multiplier while degraded (<1)
    degrade_events: int = 0         # window length, in transfer events
    # transient migration failures, retried with exponential backoff
    fail_prob: float = 0.0          # P(one attempt fails | transfer event)
    max_retries: int = 3            # attempts beyond the first
    retry_backoff_us: float = 200.0  # first backoff; doubles per retry
    # fault-storm amplification
    storm_prob: float = 0.0         # P(storm opens | fault batch, idle)
    storm_factor: float = 1.0       # fault-event multiplier while storming
    storm_events: int = 0           # storm length, in fault batches

    def enabled(self) -> bool:
        """Whether this scenario can inject anything at all."""
        return (self.degrade_prob > 0.0 or self.fail_prob > 0.0
                or self.storm_prob > 0.0)


def _mix_seed(seed: int, salt: str) -> int:
    """Deterministic, process-independent seed mix (no ``hash()``)."""
    digest = hashlib.blake2s(salt.encode(), digest_size=8).digest()
    return (int(seed) << 64) ^ int.from_bytes(digest, "big")


class FaultInjector:
    """Stateful event-ordered injector for one simulation run.

    The simulator calls :meth:`transfer` once per batched transfer event
    and :meth:`fault_events` once per fault batch; both consume RNG draws
    in that event order.  Cumulative injection accounting (retries,
    backoff seconds, degraded/storm event counts) is kept here and copied
    onto the :class:`~repro_torch.core.simulator.SimReport` by the caller.
    """

    def __init__(self, scenario: FaultScenario, salt: str = ""):
        self.scenario = scenario
        self.rng = random.Random(_mix_seed(scenario.seed, salt))
        self._degrade_left = 0      # transfer events left in the open window
        self._storm_left = 0        # fault batches left in the open storm
        # cumulative accounting, mirrored into SimReport by the simulator
        self.n_retries = 0
        self.retry_stall_s = 0.0
        self.n_degraded_xfers = 0
        self.n_storm_faults = 0

    # -- transfer events -------------------------------------------------------
    def transfer(self, seconds: float) -> tuple[float, float]:
        """One batched transfer event of clean duration ``seconds``.

        Returns ``(scale, backoff_s)``: the caller multiplies its per-chunk
        transfer times by ``scale`` (bandwidth degradation plus failed-
        attempt re-sends) and delays the transfer by ``backoff_s`` of retry
        latency on the issuing stream.  Zero-probability pathologies draw
        nothing, so a scenario that only storms leaves the transfer RNG
        stream untouched.
        """
        s = self.scenario
        scale = 1.0
        if s.degrade_prob > 0.0:
            if self._degrade_left == 0 and self.rng.random() < s.degrade_prob:
                self._degrade_left = max(1, s.degrade_events)
            if self._degrade_left > 0:
                self._degrade_left -= 1
                self.n_degraded_xfers += 1
                scale /= s.degrade_factor
        backoff_s = 0.0
        if s.fail_prob > 0.0 and seconds > 0.0:
            retries = 0
            while retries < s.max_retries and self.rng.random() < s.fail_prob:
                backoff_s += s.retry_backoff_us * 1e-6 * (2.0 ** retries)
                retries += 1
            if retries:
                self.n_retries += retries
                self.retry_stall_s += backoff_s
                scale *= 1.0 + retries          # each failed attempt re-sent
        return scale, backoff_s

    # -- fault batches ---------------------------------------------------------
    def fault_events(self, events: int) -> int:
        """One fault batch of ``events`` clean fault-group events; returns
        the (possibly storm-amplified) event count."""
        s = self.scenario
        if s.storm_prob <= 0.0 or events <= 0:
            return events
        if self._storm_left == 0 and self.rng.random() < s.storm_prob:
            self._storm_left = max(1, s.storm_events)
        if self._storm_left > 0:
            self._storm_left -= 1
            amplified = int(events * s.storm_factor)
            self.n_storm_faults += amplified - events
            return amplified
        return events


# -- scenario registry ---------------------------------------------------------
# The named scenarios table_degradation sweeps (benchmarks/paper_tables.py):
# one per pathology plus a combined worst case.  Probabilities are tuned so
# every scenario visibly hurts the oversubscribed static tiers without
# drowning the signal in noise.
SCENARIOS: dict[str, FaultScenario] = {
    s.name: s for s in (
        FaultScenario("degraded_link", seed=101,
                      degrade_prob=0.25, degrade_factor=0.25,
                      degrade_events=8),
        FaultScenario("flaky_migration", seed=202,
                      fail_prob=0.20, max_retries=3, retry_backoff_us=500.0),
        FaultScenario("fault_storm", seed=303,
                      storm_prob=0.20, storm_factor=4.0, storm_events=16),
        FaultScenario("hostile", seed=404,
                      degrade_prob=0.15, degrade_factor=0.5, degrade_events=4,
                      fail_prob=0.10, max_retries=2, retry_backoff_us=300.0,
                      storm_prob=0.15, storm_factor=3.0, storm_events=8),
    )
}


def get_scenario(name_or_scenario) -> FaultScenario:
    """Resolve a scenario name through the registry (pass-through for
    :class:`FaultScenario` objects, so callers can hand in ad-hoc ones)."""
    if isinstance(name_or_scenario, FaultScenario):
        return name_or_scenario
    try:
        return SCENARIOS[name_or_scenario]
    except KeyError:
        raise KeyError(f"unknown fault scenario {name_or_scenario!r}; "
                       f"registered: {scenario_names()}") from None


def scenario_names() -> tuple[str, ...]:
    return tuple(SCENARIOS)
