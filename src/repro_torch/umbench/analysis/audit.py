"""Engine invariant audit (DESIGN.md §14) — opt-in structural checking of
the simulator's run-coalesced residency index after every public batched op.

``UMSimulator(..., audit=True)`` installs :func:`check_invariants` behind a
single guarded call site per public op (``UMSimulator._audited``).  The
checks are pure reads over the region and queue state — no simulated
number, clock, or counter is ever touched — so ``audit=True`` is
bit-identical to ``audit=False`` by construction, and
tests/test_analysis_audit.py pins that numerically across a seed-matrix
sample.  ``audit=False`` (the default) costs exactly one ``is not None``
attribute test per op.

Invariants (the names are pinned against DESIGN.md §14's table by
tests/test_docs_consistency.py):

``stamp_order``
    Within each residency queue, live chunks in pop order carry strictly
    increasing residency stamps — append order IS stamp order, the property
    that lets the engine skip the per-eviction argsort (DESIGN.md §9).
``q_live_counters``
    Every per-region ``q_live`` pair and per-queue ``live_chunks``/
    ``live_bytes`` counter equals a recount from ``entry_ptr`` ground truth.
``run_coalescing``
    No two physically adjacent alive queue entries are mergeable (same
    region, same chunk size, both fully live, chunk-contiguous): tail-merge
    on append and adjacent-merge on compact make coalescing a maintained
    property, not a best effort.
``device_used``
    ``sim.device_used`` equals the summed bytes of device-resident chunks,
    and equals the two queues' ``live_bytes`` total.
``queue_disjoint``
    A chunk is filed under exactly one queue entry iff it is device
    resident, inside that entry's window, and counted by its ``nlive``.
``freed_absent``
    A freed region (dead slot in the allocation list) has no resident
    chunks and no queue presence of any kind.

The module is imported lazily by the simulator and must not import it
back; everything here is NumPy over plain attributes.
"""
from __future__ import annotations

import numpy as np

__all__ = ["AuditError", "INVARIANTS", "check_invariants"]

#: invariant names, in the order DESIGN.md §14 documents them
INVARIANTS = (
    "stamp_order",
    "q_live_counters",
    "run_coalescing",
    "device_used",
    "queue_disjoint",
    "freed_absent",
)


class AuditError(AssertionError):
    """An engine invariant failed right after a public simulator op.

    Carries the op (and region argument) that completed when the check
    fired, plus the invariant name — precise enough to bisect a corrupting
    strategy or engine edit from the message alone.
    """

    def __init__(self, invariant: str, op: str, region: str | None,
                 detail: str):
        self.invariant = invariant
        self.op = op
        self.region = region
        self.detail = detail
        at = op if region is None else f"{op}({region!r})"
        super().__init__(f"invariant {invariant!r} violated after {at}: "
                         f"{detail}")


def _fail(invariant: str, op: str, region: str | None, detail: str):
    raise AuditError(invariant, op, region, detail)


def _audit_queue(sim, q, op: str, region: str | None) -> None:
    """Walk one RunQueue's entries in pop order, reconciling every counter
    against ``entry_ptr`` ground truth.  Stamps are drawn from one global
    clock but the queues interleave arbitrarily, so strict stamp ascent is
    checked per queue — only while the engine maintains stamps, i.e. with
    the audit hook armed (stamps are audit-only state: with ``audit=False``
    the hot paths skip the per-chunk stamp writes and every pop-order
    reader uses queue order instead, so a direct ``check_invariants`` call
    on an unaudited sim checks everything but stamp ascent)."""
    check_stamps = sim._audit is not None
    qn = "pin" if q.qi else "un"
    if (q.nlive[:q.head] != 0).any():
        _fail("q_live_counters", op, region,
              f"{qn} queue has live entries before head={q.head}")
    total_chunks = 0
    total_bytes = 0
    last = -1
    prev = None          # (end, reg, csize, fully_live) of the previous slot
    for e in range(q.head, q.tail):
        nl = int(q.nlive[e])
        ln = int(q.length[e])
        if nl < 0 or nl > ln:
            _fail("q_live_counters", op, region,
                  f"{qn} queue entry {e}: nlive={nl} outside [0, {ln}]")
        if nl == 0:
            prev = None  # a dead slot breaks physical adjacency
            continue
        rg = int(q.reg[e])
        s = int(q.start[e])
        cz = int(q.csize[e])
        if rg < 0 or rg >= len(sim._rlist):
            _fail("queue_disjoint", op, region,
                  f"{qn} queue entry {e} names region slot {rg} "
                  f"outside the allocation list")
        r = sim._rlist[rg]
        if s < 0 or s + ln > r.nchunks:
            _fail("queue_disjoint", op, region,
                  f"{qn} queue entry {e} window [{s}, {s + ln}) exceeds "
                  f"{r.name}'s {r.nchunks} chunks")
        members = np.flatnonzero(
            r.entry_ptr[s:s + ln] == e * 2 + q.qi) + s
        if len(members) != nl:
            _fail("queue_disjoint", op, region,
                  f"{qn} queue entry {e} ({r.name}) claims nlive={nl} but "
                  f"{len(members)} chunks point at it")
        fully = nl == ln
        if prev is not None:
            pend, preg, pcz, pfull = prev
            if (pfull and fully and preg == rg and pcz == cz and pend == s):
                _fail("run_coalescing", op, region,
                      f"{qn} queue entries {e - 1} and {e} ({r.name}) are "
                      f"adjacent, fully live, and contiguous — should be "
                      f"one run")
        prev = (s + ln, rg, cz, fully)
        if check_stamps:
            stamps = r.stamp[members]
            if int(stamps[0]) <= last or (np.diff(stamps) <= 0).any():
                _fail("stamp_order", op, region,
                      f"{qn} queue entry {e} ({r.name}) breaks ascending "
                      f"stamp order at pop position {total_chunks}")
            last = int(stamps[-1])
        total_chunks += nl
        total_bytes += nl * cz
    if total_chunks != q.live_chunks:
        _fail("q_live_counters", op, region,
              f"{qn} queue live_chunks={q.live_chunks}, recount says "
              f"{total_chunks}")
    if total_bytes != q.live_bytes:
        _fail("q_live_counters", op, region,
              f"{qn} queue live_bytes={q.live_bytes}, recount says "
              f"{total_bytes}")


def check_invariants(sim, op: str, region: str | None = None) -> None:
    """Check every §14 invariant on ``sim``; raise :class:`AuditError`
    naming the violated invariant and the op that exposed it.  O(resident
    chunks) — the opt-in audit cost."""
    live_bytes = 0
    for r in sim._rlist:
        freed = sim.regions.get(r.name) is not r
        res = r.resident_mask()
        filed = r.entry_ptr >= 0
        if freed:
            if res.any() or filed.any() or r.q_live[0] or r.q_live[1]:
                _fail("freed_absent", op, region,
                      f"freed region {r.name} still has "
                      f"{int(res.sum())} resident / {int(filed.sum())} "
                      f"filed chunks (q_live={r.q_live})")
            continue
        if not np.array_equal(res, filed):
            bad = int((res != filed).sum())
            _fail("queue_disjoint", op, region,
                  f"{r.name}: residency and queue filing disagree on "
                  f"{bad} chunks")
        qi_filed = (r.entry_ptr[filed] & 1).astype(bool)
        n_pin = int(qi_filed.sum())
        n_un = int(len(qi_filed) - n_pin)
        if r.q_live[0] != n_un or r.q_live[1] != n_pin:
            _fail("q_live_counters", op, region,
                  f"{r.name}: q_live={r.q_live}, entry_ptr says "
                  f"[{n_un}, {n_pin}]")
        live_bytes += int(r.sizes[res].sum())
    if live_bytes != sim.device_used:
        _fail("device_used", op, region,
              f"device_used={sim.device_used}, resident chunks sum to "
              f"{live_bytes}")
    idx = sim._index
    if idx.un.live_bytes + idx.pin.live_bytes != sim.device_used:
        _fail("device_used", op, region,
              f"queue live_bytes {idx.un.live_bytes}+{idx.pin.live_bytes} "
              f"!= device_used={sim.device_used}")
    _audit_queue(sim, idx.un, op, region)
    _audit_queue(sim, idx.pin, op, region)
