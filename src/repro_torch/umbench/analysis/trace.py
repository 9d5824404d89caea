"""Recording simulator proxy (DESIGN.md §14): the port's copy of
``repro.umbench.analysis.trace``.

A :class:`RecordingSim` wraps a live :class:`~repro_torch.core.simulator.UMSimulator`
and records every public mutator call while delegating it unchanged — the
wrapped run is bit-identical to an unwrapped one.  Two consumers:

* the contract checker (``umbench.analysis.contracts``) tags the ops a
  strategy issues from each hook, so the ``before_step``/``serving_step``
  whitelist is checked against what the strategy *actually does* on a probe
  trace, not against its source;
* :func:`record_serving_ops` drives a full serving cell through the proxy
  and normalizes the recording into the linter's op vocabulary
  (``umbench.analysis.lint.lint_ops``), giving the request-driven serving
  traces — which have no static Workload — the same dataflow rules.

Attribute reads and writes pass straight through (the serving scheduler
assigns ``sim.t_device`` directly), so any driver of a real simulator
drives the proxy unmodified.
"""
from __future__ import annotations

import contextlib
import dataclasses

__all__ = ["Op", "RecordingSim", "record_serving_ops", "to_lint_ops"]

#: the public mutators worth recording (everything the variant strategies,
#: lowering template, and serving scheduler may call on a simulator)
RECORDED = frozenset({
    "alloc", "free",
    "advise_read_mostly", "advise_preferred_location", "advise_accessed_by",
    "unadvise_read_mostly", "unadvise_preferred_location",
    "enable_access_counters",
    "explicit_copy_to_device", "explicit_alloc", "explicit_copy_to_host",
    "prefetch", "host_write", "host_read", "kernel",
})


@dataclasses.dataclass(frozen=True)
class Op:
    """One recorded call: method name, positional args, kwargs, and the
    phase tag active when it was issued (None outside any tagged phase)."""

    name: str
    args: tuple
    kwargs: tuple              # sorted (key, value) items, hashable
    phase: str | None = None

    def arg(self, i: int = 0):
        return self.args[i] if i < len(self.args) else None


class RecordingSim:
    """Transparent recording proxy over a UMSimulator."""

    def __init__(self, sim):
        object.__setattr__(self, "_sim", sim)
        object.__setattr__(self, "ops", [])
        object.__setattr__(self, "_phase", None)

    def __getattr__(self, name):
        attr = getattr(object.__getattribute__(self, "_sim"), name)
        if name in RECORDED and callable(attr):
            ops = object.__getattribute__(self, "ops")

            def recorded(*args, _attr=attr, _name=name, **kwargs):
                ops.append(Op(_name, args,
                              tuple(sorted(kwargs.items(), key=str)),
                              object.__getattribute__(self, "_phase")))
                return _attr(*args, **kwargs)
            return recorded
        return attr

    def __setattr__(self, name, value):
        setattr(object.__getattribute__(self, "_sim"), name, value)

    @contextlib.contextmanager
    def phase(self, tag: str):
        """Tag every op recorded inside the block with ``tag`` (the
        contract checker wraps hook invocations in this)."""
        prev = object.__getattribute__(self, "_phase")
        object.__setattr__(self, "_phase", tag)
        try:
            yield self
        finally:
            object.__setattr__(self, "_phase", prev)


def to_lint_ops(ops) -> list[tuple]:
    """Normalize recorded :class:`Op` calls to the linter's event
    vocabulary (see ``umbench.analysis.lint``)."""
    out: list[tuple] = []
    for op in ops:
        if op.name == "alloc":
            out.append(("alloc", op.arg(0), int(op.arg(1))))
        elif op.name == "free":
            out.append(("free", op.arg(0)))
        elif op.name == "kernel":
            kw = dict(op.kwargs)
            out.append(("kernel", op.arg(0),
                        tuple(kw.get("reads") or ()),
                        tuple(kw.get("writes") or ())))
        elif op.name == "prefetch":
            out.append(("prefetch", op.arg(0)))
        elif op.name == "advise_read_mostly":
            out.append(("advise", op.arg(0), "read_mostly", None))
        elif op.name == "advise_preferred_location":
            out.append(("advise", op.arg(0), "preferred_location",
                        getattr(op.arg(1), "name", None)))
        elif op.name == "advise_accessed_by":
            out.append(("advise", op.arg(0), "accessed_by",
                        getattr(op.arg(1), "name", None)))
        else:
            # host I/O, unadvises, counters, explicit staging: generic
            # region references for the lifetime rules
            out.append(("use", op.arg(0), op.name))
    return out


def record_serving_ops(pattern="poisson_short", strategy="um",
                       platform="p9-volta-nvlink", regime="kv_150",
                       granularity: str = "group", config=None,
                       raw: bool = False) -> list:
    """Run one serving cell through a recording proxy and return the
    lint-ready op stream (or, with ``raw=True``, the unnormalized
    :class:`Op` records — the form ``analysis.bounds.ops_bounds``
    replays).  Mirrors ``serving.sweep.run_serving_cell``'s sizing and
    salting exactly (same pattern trace, same budgets), minus the
    metrics layer."""
    from repro_torch.core.simulator import OversubscriptionError, UMSimulator
    from repro_torch.umbench import platforms as plat
    from repro_torch.umbench import variants as var
    from repro_torch.umbench.serving.scheduler import ServingConfig, serve
    from repro_torch.umbench.serving.sweep import SERVING_REGIMES
    from repro_torch.umbench.serving.traffic import get_pattern

    p = plat.PLATFORMS[platform] if isinstance(platform, str) else platform
    strat = (var.get_strategy(strategy) if isinstance(strategy, str)
             else strategy)
    pat = get_pattern(pattern)
    if not strat.available(p):
        return []
    sim = UMSimulator(p, granularity=granularity)
    rec = RecordingSim(sim)
    salt = (f"serve_{pat.name}:{p.name}:{strat.name}:{regime}:"
            f"{granularity}")
    requests = pat.generate(salt=salt)
    try:
        serve(rec, strat, requests, SERVING_REGIMES[regime],
              config or ServingConfig())
    except OversubscriptionError:
        pass    # explicit under KV oversubscription: lint the partial trace
    return rec.ops if raw else to_lint_ops(rec.ops)
