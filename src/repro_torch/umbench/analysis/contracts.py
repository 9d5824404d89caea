"""Strategy contract checker (DESIGN.md §14): the port's copy of
``repro.umbench.analysis.contracts``.

Every registered :class:`~repro_torch.umbench.variants.VariantStrategy` is held
to two contracts:

* **Platform gate** — ``available()`` must implement exactly the documented
  §8 gate: the paper tiers exist everywhere, the coherent-fabric tiers
  (``svm_remote``, ``um_hybrid_counters``) require
  ``host_can_access_device and device_can_access_host``, and the zero-copy
  tier requires ``device_can_access_host`` alone.  Checked by evaluating
  ``available()`` against the gate predicate on every registered platform
  (UMC101), with the table itself kept total: an unregistered strategy is
  undocumented (UMC102) and a stale table entry names a strategy that no
  longer exists (UMC104).

* **Hook whitelist** — the per-step hooks (``before_step``,
  ``serving_step``) run *between* trace steps, so they may only issue
  hint-class ops: advise/unadvise, prefetch, and access-counter arming.
  Anything else (frees, host I/O, allocations, kernels, explicit staging)
  would silently rewrite the trace the cell claims to measure.  Checked
  behaviourally (UMC103): the strategy lowers a thrash-inducing probe
  workload — and drives a small serving trace — on a
  :class:`~repro_torch.umbench.analysis.trace.RecordingSim`, with the hooks
  wrapped in phase tags; any tagged op outside :data:`SANCTIONED_HOOK_OPS`
  is a violation.  The probe oversubscribes the device so the adaptive
  tiers' thrash-triggered paths actually execute.
"""
from __future__ import annotations

import copy

from repro_torch.core.advise import Accessor, MemorySpace
from repro_torch.core.simulator import OversubscriptionError, SimPlatform, UMSimulator
from repro_torch.umbench import platforms as plat
from repro_torch.umbench import variants as var
from repro_torch.umbench import workload as wk
from repro_torch.umbench.analysis.lint import Finding
from repro_torch.umbench.analysis.trace import RecordingSim

__all__ = [
    "CONTRACT_RULES",
    "EXPECTED_GATES",
    "SANCTIONED_HOOK_OPS",
    "check_contracts",
]

CONTRACT_RULES: dict[str, tuple[str, str]] = {
    "UMC101": ("error", "available() disagrees with the documented "
                        "platform gate"),
    "UMC102": ("error", "registered strategy missing from the documented "
                        "gate table"),
    "UMC103": ("error", "before_step/serving_step issued an op outside "
                        "the sanctioned hook whitelist"),
    "UMC104": ("error", "stale gate-table entry: strategy no longer "
                        "registered"),
}

#: documented §8 gate per registered strategy (DESIGN.md §14 mirrors this)
EXPECTED_GATES: dict[str, str] = {
    "explicit": "all",
    "um": "all",
    "um_advise": "all",
    "um_prefetch": "all",
    "um_both": "all",
    "um_prefetch_pipelined": "all",
    "um_both_pipelined": "all",
    "um_adaptive_advise": "all",
    "um_prefetch_adaptive": "all",
    "svm_remote": "coherent_fabric",
    "um_hybrid_counters": "coherent_fabric",
    "um_pinned_zero_copy": "zero_copy",
}

GATE_PREDICATES = {
    "all": lambda p: True,
    "coherent_fabric": lambda p: (p.host_can_access_device
                                  and p.device_can_access_host),
    "zero_copy": lambda p: p.device_can_access_host,
}

#: the only sim ops a per-step hook may issue — hints, never trace steps
SANCTIONED_HOOK_OPS = frozenset({
    "advise_read_mostly", "advise_preferred_location", "advise_accessed_by",
    "unadvise_read_mostly", "unadvise_preferred_location",
    "enable_access_counters", "prefetch",
})

# fully coherent so every registered tier is available to probe, and small
# enough (64 MB = 32 fault groups) that the oversubscribed probe runs in
# milliseconds while still thrashing
PROBE_PLATFORM = SimPlatform(
    name="probe-coherent",
    device_mem_gb=64 / 1024,
    link_bw_gbs=50.0,
    device_bw_gbs=500.0,
    device_flops_tps=5.0,
    fault_latency_us=20.0,
    host_can_access_device=True,
    device_can_access_host=True,
)

MB = 1024 * 1024


def probe_workload() -> wk.Workload:
    """A 1.2x-oversubscribed trace exercising every hook surface: all three
    advise kinds (PRE_INIT and POST_INIT), a prefetch pool, alternating
    kernels that force eviction churn (so the thrash-adaptive hooks fire),
    and a mid-compute Free."""
    b = wk.WorkloadBuilder("contract-probe")
    for name in ("A", "B", "C"):
        b.alloc(name, 26 * MB).host_write(name)
    b.advise_preferred_location("A", MemorySpace.DEVICE, when=wk.PRE_INIT)
    b.advise_read_mostly("B")
    b.advise_accessed_by("C", Accessor.HOST)
    b.prefetch("A", "B")
    for i in range(5):
        b.kernel(f"k{2 * i}", flops=1e9, reads=("A", "C"), writes=("B",))
        b.kernel(f"k{2 * i + 1}", flops=1e9, reads=("B", "C"), writes=("A",))
    b.free("C")
    b.kernel("k_tail", flops=1e9, reads=("A",), writes=("B",))
    b.readback("B")
    return b.build()


def _probe_requests():
    from repro_torch.umbench.serving.traffic import Request
    return tuple(Request(rid=i, arrival_s=0.05 * i, prompt_len=24, gen_len=8)
                 for i in range(6))


def _hook_violations(strategy) -> list[Finding]:
    """Behavioural UMC103 check: run the probe trace (and a small serving
    trace) under ``strategy`` with phase-tagged hooks on a recording
    proxy."""
    findings: list[Finding] = []

    def tagged(rec, name, orig):
        def hook(*args):
            with rec.phase(name):
                orig(*args)
        return hook

    crashed = None
    # workload side: before_step
    rec = RecordingSim(UMSimulator(PROBE_PLATFORM))
    probe = copy.copy(strategy)
    probe.before_step = tagged(rec, "before_step", strategy.before_step)
    try:
        probe.lower(probe_workload(), rec)
    except OversubscriptionError:
        pass        # explicit cannot stage the oversubscribed probe
    except Exception as e:  # noqa: BLE001 — judged against the recording
        crashed = e
    # serving side: serving_step
    srec = RecordingSim(UMSimulator(PROBE_PLATFORM))
    sprobe = copy.copy(strategy)
    sprobe.serving_step = tagged(srec, "serving_step", strategy.serving_step)
    try:
        from repro_torch.umbench.serving.scheduler import ServingConfig, serve
        # small decode blocks so the KV cache fits the probe device in
        # units, while kv_frac=1.5 still oversubscribes it in total
        serve(srec, sprobe, _probe_requests(), kv_frac=1.5,
              config=ServingConfig(kv_block_tokens=8))
    except OversubscriptionError:
        pass
    except Exception as e:  # noqa: BLE001
        crashed = e
    for op in rec.ops + srec.ops:
        if op.phase is not None and op.name not in SANCTIONED_HOOK_OPS:
            findings.append(Finding(
                "UMC103", CONTRACT_RULES["UMC103"][0], -1, strategy.name,
                f"strategy {strategy.name!r} issued {op.name}"
                f"{op.args!r} from its {op.phase} hook; sanctioned ops: "
                f"{sorted(SANCTIONED_HOOK_OPS)}"))
    if crashed is not None and not findings:
        # a crash with no hook violation on record is a real strategy bug,
        # not downstream fallout of a violation — fail loudly
        raise crashed
    return findings


def check_contracts(strategies=None, *, hooks: bool = True) -> list[Finding]:
    """Check the gate and hook contracts for ``strategies`` (default: the
    whole registry).  ``hooks=False`` skips the behavioural probe (the
    cheap registry-only mode)."""
    names = tuple(strategies) if strategies else var.strategy_names()
    findings: list[Finding] = []
    for stale in sorted(set(EXPECTED_GATES) - set(var.strategy_names())):
        findings.append(Finding(
            "UMC104", CONTRACT_RULES["UMC104"][0], -1, stale,
            f"gate table documents {stale!r}, which is not registered"))
    for name in names:
        strategy = var.get_strategy(name)
        gate = EXPECTED_GATES.get(name)
        if gate is None:
            findings.append(Finding(
                "UMC102", CONTRACT_RULES["UMC102"][0], -1, name,
                f"strategy {name!r} is registered but missing from the "
                f"documented gate table"))
        else:
            pred = GATE_PREDICATES[gate]
            wrong = [p.name for p in plat.PLATFORMS.values()
                     if strategy.available(p) != pred(p)]
            if wrong:
                findings.append(Finding(
                    "UMC101", CONTRACT_RULES["UMC101"][0], -1, name,
                    f"strategy {name!r} gate disagrees with documented "
                    f"{gate!r} on platforms {wrong}"))
        if hooks:
            findings.extend(_hook_violations(strategy))
    return findings
