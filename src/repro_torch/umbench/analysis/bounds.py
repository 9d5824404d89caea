"""umbound — symbolic residency abstract interpretation (DESIGN.md §16).

Every BENCH cell is a measurement taken by a heavily optimized engine whose
only other correctness oracle is bit-parity with the seed simulator on fixed
matrices.  This module derives **provable lower/upper bounds** on the
engine's transfer counters for a cell *without running the engine*: an
:class:`AbstractSim` implements the simulator's public mutator surface over
an abstract residency domain and is driven by the very same
``VariantStrategy.lower`` (or a recorded serving op stream), so the bound
derivation exercises the real lowering, not a parallel model of it.

The abstract domain is two-phase:

* **exact phase** — while device occupancy provably never exceeds capacity,
  every state transition the engine makes is independent of LRU order
  (populated masks, advise state, duplicate invalidation, partial-kernel
  cursors, prefix selections are all deterministic; LRU only picks eviction
  *victims*), so the interpreter mirrors per-chunk state and every counter
  is an exact point interval.
* **widened phase** — at the first operation that *could* evict (a kernel or
  prefetch whose insertions exceed free capacity), residency widens to an
  interval: the may-resident mask ``res_hi`` over-approximates the true
  resident set (must-resident drops to the empty set), populated masks keep
  must/may bounds, and counters become intervals.  Upper bounds come from
  worst-case refaulting (no coalescing, re-duplication page explosion,
  eager-restore ping-pong); lower bounds come from compulsory traffic —
  chunks provably non-resident must fault, and per kernel the touched
  migrating bytes ``T`` minus device capacity bound inserted, evicted and
  populated-HtoD bytes from below (capacity pigeonhole: at most ``capacity``
  of ``T`` can be resident when the kernel starts, and mid-kernel removals
  are evictions only).

Strategy awareness enters through :meth:`VariantStrategy.static_summary`
(``umbench.variants.StrategySummary``): remote tiers pin their regions
host-side at allocation, so the interpretation keeps them empty and bounds
faults/migration/evictions at exactly zero with no special-casing; the
adaptive tiers may shed advises or suspend prefetch windows at runtime, so
once widened the interpreter demotes shed-able advise state (READ_MOSTLY,
PREFERRED_LOCATION(DEVICE)) to three-valued *maybe* before every op.

Seconds are bounded per rate class — fault-path HtoD at
``link_bw * fault_migration_efficiency``, bulk HtoD (explicit staging,
prefetch, eager restore) and all DtoH at full ``link_bw``, remote traffic at
``link_bw * remote_access_efficiency`` — so the transfer-time interval stays
tight instead of dividing one byte total by the slowest rate.

Injected-fault cells are out of scope: the fault injector amplifies
counters by design, so the harness only cross-checks clean cells.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.advise import Accessor, MemorySpace
from repro_torch.core.simulator import GB, OversubscriptionError, SimPlatform

__all__ = [
    "MAYBE", "QUANTITIES", "AbstractSim", "CellBounds",
    "workload_bounds", "ops_bounds", "bounds_for_cell", "verify_cell",
]

#: three-valued uncertainty marker for widened advise state
MAYBE = "maybe"

#: the bounded quantities, name -> what the interval brackets (pinned by
#: DESIGN.md §16 and tests/test_docs_consistency.py)
QUANTITIES = {
    "n_faults": "fault events (GPU page/fault-group faults + CPU-side "
                "faults on host I/O migrations)",
    "htod_bytes": "host-to-device migrated bytes (fault-path + bulk "
                  "staging/prefetch/eager-restore)",
    "dtoh_bytes": "device-to-host bytes (host I/O migrations, explicit "
                  "readback, prefetch-to-host, eviction write-backs)",
    "n_evictions": "evicted chunks (capacity victims, duplicates included)",
    "xfer_s": "total transfer seconds (htod_s + dtoh_s + remote_s), "
              "bounded per rate class",
}


class _NoThrash:
    """The report stub's thrash window: the abstract run never observes
    evictions pre-flip (there are none), and post-flip the adaptive
    widening covers every shed/suspend decision, so the strategies' only
    runtime read answers False."""

    @staticmethod
    def thrashing() -> bool:
        return False


class _ReportStub:
    thrash = _NoThrash()


class _ARegion:
    """Abstract per-chunk state of one region — the fields the engine's
    ``Region`` carries that are visible to counters, with must/may
    populated masks for the widened phase."""

    def __init__(self, name: str, nbytes: int, role: str, chunk_bytes: int):
        self.name = name
        self.nbytes = int(nbytes)
        self.role = role
        self.chunk_bytes = int(chunk_bytes)
        n = max(1, math.ceil(self.nbytes / self.chunk_bytes))
        self.nchunks = n
        sizes = np.full(n, self.chunk_bytes, dtype=np.int64)
        rem = self.nbytes - (n - 1) * self.chunk_bytes
        sizes[-1] = rem if rem > 0 else self.chunk_bytes
        self.sizes = sizes
        self.bytes_total = int(sizes.sum())
        # exact phase: mirrors of the engine's masks
        self.on_device = np.zeros(n, dtype=bool)
        self.duplicated = np.zeros(n, dtype=bool)
        self.populated = np.zeros(n, dtype=bool)
        # widened phase: may-resident / must- and may-populated
        self.res_hi: np.ndarray | None = None
        self.pop_lo: np.ndarray | None = None
        self.pop_hi: np.ndarray | None = None
        # advise state; read_mostly/preferred may demote to MAYBE once
        # widened under an adaptive strategy
        self.read_mostly: bool | str = False
        self.preferred: MemorySpace | str | None = None
        self.accessed_by: tuple[Accessor, ...] = ()
        self.counter_threshold: float | None = None
        self.touch_count: np.ndarray | None = None
        self.dup_ever = False
        self.cursor = 0

    # -- views the strategies read --------------------------------------------
    def resident_mask(self) -> np.ndarray:
        if self.res_hi is not None:
            return self.res_hi
        return self.on_device | self.duplicated

    def chunk_size(self, idx: int) -> int:
        return int(self.sizes[idx])

    def mask_bytes(self, mask: np.ndarray) -> int:
        """``sizes[mask].sum()`` without materializing the selection —
        every chunk shares one size except possibly the last, so a
        popcount plus a last-chunk adjustment is enough (the page-mode
        hot path: regions are 10^5-10^6 chunks)."""
        n = int(np.count_nonzero(mask))
        b = n * self.chunk_bytes
        if n and mask[-1]:
            b += int(self.sizes[-1]) - self.chunk_bytes
        return b

    def _widen(self) -> None:
        if self.res_hi is None:
            self.res_hi = self.on_device | self.duplicated
            self.pop_lo = self.populated.copy()
            self.pop_hi = self.populated.copy()

    @property
    def dup_possible(self) -> bool:
        return self.dup_ever or self.read_mostly in (True, MAYBE)


@dataclasses.dataclass(frozen=True)
class CellBounds:
    """Provable [lo, hi] brackets for one cell's transfer counters.

    ``exact`` is True when the interpretation never widened (device
    occupancy provably never reached capacity): every interval is then a
    point and the cross-check is a full equality oracle, not a sandwich.
    """

    n_faults: tuple[int, int]
    htod_bytes: tuple[int, int]
    dtoh_bytes: tuple[int, int]
    n_evictions: tuple[int, int]
    xfer_s: tuple[float, float]
    exact: bool

    #: relative slack on the seconds bracket only — the abstract
    #: interpreter sums bytes per rate class and divides once, the engine
    #: divides per batch, so the two differ by float associativity
    REL_EPS = 1e-6
    ABS_EPS = 1e-9

    def quantities(self) -> dict[str, tuple]:
        return {q: getattr(self, q) for q in QUANTITIES}

    @staticmethod
    def measured(report) -> dict[str, float]:
        """The report counters each bound brackets, as one dict."""
        return {
            "n_faults": report.n_faults,
            "htod_bytes": report.htod_bytes,
            "dtoh_bytes": report.dtoh_bytes,
            "n_evictions": report.n_evictions,
            "xfer_s": report.htod_s + report.dtoh_s + report.remote_s,
        }

    def check(self, report) -> list[str]:
        """Cross-check a measured ``SimReport`` against the bounds; returns
        one violation string per quantity outside its bracket (empty list
        == the measurement is consistent with the abstract semantics)."""
        out = []
        m = self.measured(report)
        for q in ("n_faults", "htod_bytes", "dtoh_bytes", "n_evictions"):
            lo, hi = getattr(self, q)
            if not (lo <= m[q] <= hi):
                out.append(f"{q}={m[q]} outside [{lo}, {hi}]")
        lo, hi = self.xfer_s
        v = m["xfer_s"]
        if not (lo - self.REL_EPS * lo - self.ABS_EPS <= v
                <= hi + self.REL_EPS * hi + self.ABS_EPS):
            out.append(f"xfer_s={v:.9g} outside [{lo:.9g}, {hi:.9g}]")
        return out

    def tightness(self, report) -> dict[str, float | None]:
        """Per-quantity hi/measured ratio (None when measured is 0 and the
        bound is not — an uninformative ratio, not a violation)."""
        out: dict[str, float | None] = {}
        for q, v in self.measured(report).items():
            hi = getattr(self, q)[1]
            out[q] = (1.0 if hi == 0 else None) if v == 0 else hi / v
        return out


class AbstractSim:
    """The abstract interpreter: a drop-in for ``UMSimulator`` as far as
    the variant strategies' *lowering* is concerned (public mutators, the
    capacity/chunk attributes, ``regions``, a thrash-window stub), walking
    the abstract domain described in the module docstring."""

    def __init__(self, platform: SimPlatform, granularity: str = "group",
                 summary=None):
        self.p = platform
        self.granularity = granularity
        self.chunk_bytes = (platform.page_bytes if granularity == "page"
                            else platform.fault_group_bytes)
        self.regions: dict[str, _ARegion] = {}
        self.report = _ReportStub()
        self.summary = summary
        self.adaptive = bool(summary is not None and summary.adaptive)
        self.device_used = 0            # exact phase; insertion hi after
        self.widened = False
        # counter intervals, split by transfer rate class
        self.f_lo = self.f_hi = 0                   # fault events
        self.hf_lo = self.hf_hi = 0                 # htod @ fme rate
        self.hb_lo = self.hb_hi = 0                 # htod @ full bw
        self.d_lo = self.d_hi = 0                   # dtoh @ full bw
        self.r_lo = self.r_hi = 0                   # remote @ rae rate
        self.e_lo = 0                               # eviction lower bound
        # cumulative insertions: every eviction victim was inserted first,
        # so these cap n_evictions / eviction write-back dtoh from above
        self.ins_chunks = 0
        self.ins_bytes = 0

    @property
    def device_capacity(self) -> int:
        return int(self.p.device_mem_gb * GB)

    # -- phase machinery -------------------------------------------------------
    def _flip(self) -> None:
        if self.widened:
            return
        self.widened = True
        for r in self.regions.values():
            r._widen()

    def _enter(self) -> None:
        """Per-op entry: under an adaptive strategy, once widened, any
        shed-able advise may have been withdrawn at any point in the real
        run (thrash-triggered), so READ_MOSTLY / PREFERRED_LOCATION(DEVICE)
        demote to MAYBE before the op is interpreted."""
        if self.widened and self.adaptive:
            for r in self.regions.values():
                if r.read_mostly is True:
                    r.read_mostly = MAYBE
                if r.preferred is MemorySpace.DEVICE:
                    r.preferred = MAYBE

    def _n_events(self, r: _ARegion, ids: np.ndarray) -> int:
        """The engine's coalesced fault-event count for a chunk set — the
        provable minimum (every fault path emits at least one event per
        touched fault group) and the batched path's exact count."""
        if not len(ids):
            return 0
        if (self.granularity == "group"
                or r.chunk_bytes >= self.p.fault_group_bytes):
            return len(ids)
        groups = (ids.astype(np.int64) * r.chunk_bytes
                  ) // self.p.fault_group_bytes
        return len(np.unique(groups))

    def _insert(self, nchunks: int, nbytes: int) -> None:
        self.ins_chunks += int(nchunks)
        self.ins_bytes += int(nbytes)

    @staticmethod
    def _nch(r: _ARegion, nbytes: int | None) -> int:
        nb = r.nbytes if nbytes is None else nbytes
        return min(r.nchunks, max(1, math.ceil(nb / r.chunk_bytes)))

    # -- allocation & advises --------------------------------------------------
    def alloc(self, name: str, nbytes: int, role: str = "data") -> _ARegion:
        self._enter()
        if name in self.regions:
            raise ValueError(f"region {name} exists")
        r = _ARegion(name, int(nbytes), role, self.chunk_bytes)
        if self.widened:
            r._widen()
        self.regions[name] = r
        return r

    def free(self, name: str) -> None:
        self._enter()
        r = self.regions.pop(name)
        if self.widened:
            # definite removal: the freed chunks leave without a transfer
            r.res_hi[:] = False
        else:
            self.device_used -= int(r.sizes[r.on_device | r.duplicated].sum())

    def advise_read_mostly(self, name: str) -> None:
        self._enter()
        self.regions[name].read_mostly = True

    def advise_preferred_location(self, name: str, space: MemorySpace) -> None:
        self._enter()
        r = self.regions[name]
        r.preferred = space
        if space is not MemorySpace.DEVICE or not self.p.host_can_access_device:
            return
        if self.widened:
            # up to ``free`` bytes of unpopulated chunks may be inserted
            cand = ~r.pop_lo & ~r.res_hi
            if cand.any():
                r.res_hi |= cand
                self._insert(int(cand.sum()), int(r.sizes[cand].sum()))
            return
        # exact: virgin pages are created at the preferred location up to
        # free capacity, in chunk order, with no transfer (engine semantics)
        cand = np.nonzero(~r.populated & ~(r.on_device | r.duplicated))[0]
        if len(cand):
            free = self.device_capacity - self.device_used
            csum = np.cumsum(r.sizes[cand])
            k = int(np.searchsorted(csum, free, side="right"))
            if k:
                ins = cand[:k]
                r.on_device[ins] = True
                b = int(r.sizes[ins].sum())
                self.device_used += b
                self._insert(k, b)

    def advise_accessed_by(self, name: str, accessor: Accessor) -> None:
        self._enter()
        r = self.regions[name]
        r.accessed_by = r.accessed_by + (accessor,)

    def unadvise_read_mostly(self, name: str) -> None:
        self._enter()
        r = self.regions[name]
        r.read_mostly = False
        if self.widened:
            return                  # dup-only drops: res_hi stays a superset
        gone = r.duplicated & ~r.on_device
        self.device_used -= int(r.sizes[gone].sum())
        r.duplicated[:] = False

    def unadvise_preferred_location(self, name: str) -> None:
        self._enter()
        self.regions[name].preferred = None

    def enable_access_counters(self, name: str, threshold: float) -> None:
        self._enter()
        if threshold < 0:
            raise ValueError(f"counter threshold must be >= 0: {threshold}")
        r = self.regions[name]
        r.counter_threshold = float(threshold)
        if r.touch_count is None:
            r.touch_count = np.zeros(r.nchunks, dtype=np.int64)

    # -- explicit staging ------------------------------------------------------
    def explicit_copy_to_device(self, name: str) -> None:
        self._enter()
        r = self.regions[name]
        if self.widened:
            b = int(r.sizes.sum())
            self.hb_hi += b
            self._insert(r.nchunks, b)
            r.res_hi[:] = True
            r.pop_hi[:] = True
            return
        nonres = ~(r.on_device | r.duplicated)
        b = int(r.sizes[nonres].sum())
        if self.device_used + b > self.device_capacity:
            raise OversubscriptionError(
                f"explicit allocation of {r.name} exceeds device memory")
        self.hb_lo += b
        self.hb_hi += b
        r.populated[nonres] = True
        r.on_device[nonres] = True
        self.device_used += b
        self._insert(int(nonres.sum()), b)

    def explicit_alloc(self, name: str) -> None:
        self._enter()
        r = self.regions[name]
        if self.widened:
            self._insert(r.nchunks, int(r.sizes.sum()))
            r.res_hi[:] = True
            return
        nonres = ~(r.on_device | r.duplicated)
        b = int(r.sizes[nonres].sum())
        if self.device_used + b > self.device_capacity:
            raise OversubscriptionError(
                f"explicit allocation of {r.name} exceeds device memory")
        r.on_device[nonres] = True
        self.device_used += b
        self._insert(int(nonres.sum()), b)

    def explicit_copy_to_host(self, name: str) -> None:
        self._enter()
        r = self.regions[name]
        if self.widened:
            self.d_hi += int(r.sizes[r.res_hi].sum())
            return
        b = int(r.sizes[r.on_device].sum())
        self.d_lo += b
        self.d_hi += b

    # -- prefetch --------------------------------------------------------------
    def prefetch(self, name: str, dst: MemorySpace = MemorySpace.DEVICE,
                 nbytes: int | None = None) -> None:
        self._enter()
        r = self.regions[name]
        nch = r.nchunks if nbytes is None else self._nch(r, nbytes)
        if dst is MemorySpace.DEVICE:
            if not self.widened:
                cand = ~(r.on_device[:nch] | r.duplicated[:nch])
                b = int(r.sizes[:nch][cand].sum())
                if self.device_used + b > self.device_capacity:
                    self._flip()            # the copy would have to evict
                else:
                    self.hb_lo += b
                    self.hb_hi += b
                    r.populated[:nch][cand] = True
                    if r.read_mostly:
                        r.duplicated[:nch][cand] = True
                        r.dup_ever = True
                    else:
                        r.on_device[:nch][cand] = True
                    self.device_used += b
                    self._insert(int(cand.sum()), b)
                    return
            # widened: every window chunk may be copied (none must be —
            # it may be resident already, or an adaptive tier may have
            # suspended the window)
            b = int(r.sizes[:nch].sum())
            self.hb_hi += b
            self._insert(nch, b)
            r.res_hi[:nch] = True
            r.pop_hi[:nch] = True
            if r.read_mostly in (True, MAYBE):
                r.dup_ever = True
            return
        # prefetch to host: un-pins a DEVICE preference, drops duplicates
        # for free, moves authoritative chunks with a DtoH copy
        if r.preferred in (MemorySpace.DEVICE, MAYBE):
            r.preferred = None
        if self.widened:
            self.d_hi += int(r.sizes[:nch][r.res_hi[:nch]].sum())
            r.res_hi[:nch] = False          # definite removal either way
            return
        dup = r.duplicated[:nch] & ~r.on_device[:nch]
        self.device_used -= int(r.sizes[:nch][dup].sum())
        r.duplicated[:nch] = False
        dev = r.on_device[:nch]
        b = int(r.sizes[:nch][dev].sum())
        self.d_lo += b
        self.d_hi += b
        self.device_used -= b
        r.on_device[:nch] = False

    # -- host I/O --------------------------------------------------------------
    def host_write(self, name: str, nbytes: int | None = None) -> None:
        self._enter()
        r = self.regions[name]
        nch = self._nch(r, nbytes)
        if self.widened:
            self._host_write_widened(r, nch)
            return
        # duplicate invalidation: the device copy is dropped for free
        dup = r.duplicated[:nch]
        if dup.any():
            gone = dup & ~r.on_device[:nch]
            self.device_used -= int(r.sizes[:nch][gone].sum())
            r.duplicated[:nch] = False
        dev_ids = np.nonzero(r.on_device[:nch])[0]
        if len(dev_ids):
            b = int(r.sizes[dev_ids].sum())
            wants_remote = (Accessor.HOST in r.accessed_by
                            or r.preferred is MemorySpace.DEVICE)
            if wants_remote and self.p.host_can_access_device:
                self.r_lo += b
                self.r_hi += b
            else:
                ev = self._n_events(r, dev_ids)
                self.f_lo += ev
                self.f_hi += ev
                self.d_lo += b
                self.d_hi += b
                self.device_used -= b
                r.on_device[dev_ids] = False
        r.populated[:nch] = True

    def _host_write_widened(self, r: _ARegion, nch: int) -> None:
        res = r.res_hi[:nch]
        b = int(r.sizes[:nch][res].sum())
        if b:
            if Accessor.HOST in r.accessed_by:
                wr = True
            elif r.preferred is MemorySpace.DEVICE:
                wr = True
            elif r.preferred is MAYBE:
                wr = MAYBE
            else:
                wr = False
            remote_ok = wr in (True, MAYBE) and self.p.host_can_access_device
            migrate_ok = wr in (False, MAYBE) or not self.p.host_can_access_device
            if remote_ok:
                self.r_hi += b
            if migrate_ok:
                self.f_hi += int(res.sum())
                self.d_hi += b
                if not remote_ok:
                    # definite branch: every resident prefix chunk leaves
                    # (duplicates dropped, authoritative chunks migrated)
                    r.res_hi[:nch] = False
        r.pop_lo[:nch] = True
        r.pop_hi[:nch] = True

    def host_read(self, name: str, nbytes: int | None = None) -> None:
        self._enter()
        r = self.regions[name]
        nch = self._nch(r, nbytes)
        if self.widened:
            res = r.res_hi[:nch]
            b = int(r.sizes[:nch][res].sum())
            if not b:
                return
            if (Accessor.HOST in r.accessed_by
                    and self.p.host_can_access_device):
                self.r_hi += b
            else:
                self.f_hi += int(res.sum())
                self.d_hi += b
                if not r.dup_possible:
                    # without duplicates the whole resident prefix is
                    # authoritative: it definitely migrates out
                    r.res_hi[:nch] = False
            return
        sel = np.nonzero(r.on_device[:nch] & ~r.duplicated[:nch])[0]
        if not len(sel):
            return
        b = int(r.sizes[sel].sum())
        if Accessor.HOST in r.accessed_by and self.p.host_can_access_device:
            self.r_lo += b
            self.r_hi += b
        else:
            ev = self._n_events(r, sel)
            self.f_lo += ev
            self.f_hi += ev
            self.d_lo += b
            self.d_hi += b
            self.device_used -= b
            r.on_device[sel] = False

    # -- kernels ---------------------------------------------------------------
    def kernel(self, name: str, *, flops: float, reads: list[str],
               writes: list[str], bytes_touched: float | None = None,
               partial=None) -> None:
        self._enter()
        partial = partial or {}
        read_set = [self.regions[n] for n in reads]
        write_set = [self.regions[n] for n in writes]

        def chunk_ids(r: _ARegion) -> np.ndarray | None:
            frac = partial.get(r.name)
            if frac is None:
                return None            # whole region (the common case)
            n = max(1, int(frac * r.nchunks))
            ids = (r.cursor + np.arange(n)) % r.nchunks
            r.cursor = (r.cursor + n) % r.nchunks
            return ids

        touched: dict[str, np.ndarray] = {}
        for r in read_set + write_set:
            if r.name not in touched:
                touched[r.name] = chunk_ids(r)

        if not self.widened:
            # flip test: mid-kernel the only removals are evictions, so the
            # engine evicts iff occupancy plus every insertable touched byte
            # exceeds capacity.  Pure-remote regions never insert; hybrid
            # regions count whole (cold chunks may promote — conservative).
            est = 0
            for nm, ids in touched.items():
                r = self.regions[nm]
                if (r.preferred is MemorySpace.HOST
                        and self.p.device_can_access_host
                        and r.counter_threshold is None):
                    continue
                if ids is None:
                    est += r.mask_bytes(~(r.on_device | r.duplicated))
                else:
                    nonres = ~(r.on_device[ids] | r.duplicated[ids])
                    est += int(r.sizes[ids[nonres]].sum())
            if self.device_used + est > self.device_capacity:
                self._flip()
        if self.widened:
            self._kernel_widened(read_set, write_set, touched)
            return

        # exact interpretation — mirrors the engine's kernel loop
        # (materialize whole-region touches; the exact walk is segment-wise)
        touched = {nm: (np.arange(self.regions[nm].nchunks)
                        if ids is None else ids)
                   for nm, ids in touched.items()}
        for r in write_set:
            ids = touched[r.name]
            d = ids[r.duplicated[ids]]
            if len(d):              # device write promotes dup -> exclusive
                r.duplicated[d] = False
                r.on_device[d] = True
        for r in read_set + write_set:
            pinned_host = r.preferred is MemorySpace.HOST
            dup_flag = bool(r.read_mostly and r in read_set
                            and r not in write_set)
            ids = touched[r.name]
            res = r.on_device[ids] | r.duplicated[ids]
            brk = np.flatnonzero(np.diff(res)) + 1
            for seg in np.split(ids, brk):
                if r.on_device[seg[0]] or r.duplicated[seg[0]]:
                    continue                            # resident: touch
                if pinned_host and self.p.device_can_access_host:
                    if r.counter_threshold is None:
                        b = int(r.sizes[seg].sum())
                        self.r_lo += b
                        self.r_hi += b
                    else:
                        self._count_and_promote(r, seg, dup_flag)
                else:
                    self._fault_batch(r, seg, dup_flag)
        for r in write_set:
            r.populated[touched[r.name]] = True
        # no eager restore: it only runs under pressure, and the exact
        # phase is by construction pressure-free

    def _count_and_promote(self, r: _ARegion, seg: np.ndarray,
                           dup_flag: bool) -> None:
        """Exact mirror of ``residency.counter_promote_split`` + promotion:
        increment first, promote at >= threshold, reset promoted counters
        (a re-evicted chunk restarts cold)."""
        r.touch_count[seg] += 1
        if r.counter_threshold == math.inf:
            b = int(r.sizes[seg].sum())
            self.r_lo += b
            self.r_hi += b
            return
        hot_mask = r.touch_count[seg] >= r.counter_threshold
        hot, cold = seg[hot_mask], seg[~hot_mask]
        if len(hot):
            r.touch_count[hot] = 0
            self._fault_batch(r, hot, dup_flag)
        b = int(r.sizes[cold].sum())
        self.r_lo += b
        self.r_hi += b

    def _fault_batch(self, r: _ARegion, ids: np.ndarray,
                     dup_flag: bool) -> None:
        """Exact pressure-free fault accounting: virgin chunks populate with
        coalesced events and no copy; populated chunks migrate at the fme
        rate with coalesced events (the unpressured dup path halves latency
        but keeps the event count)."""
        virgin = ~r.populated[ids]
        ev = self._n_events(r, ids[virgin]) + self._n_events(r, ids[~virgin])
        self.f_lo += ev
        self.f_hi += ev
        pm_b = int(r.sizes[ids[~virgin]].sum())
        self.hf_lo += pm_b
        self.hf_hi += pm_b
        r.populated[ids] = True
        if dup_flag:
            r.duplicated[ids[~virgin]] = True
            r.on_device[ids[virgin]] = True
            if (~virgin).any():
                r.dup_ever = True
        else:
            r.on_device[ids] = True
        b = int(r.sizes[ids].sum())
        self.device_used += b
        self._insert(len(ids), b)

    def _kernel_widened(self, read_set, write_set, touched) -> None:
        cap = self.device_capacity
        # ---- upper bounds: every occurrence in the engine's loop order may
        # refault everything it touches (a region read *and* written is
        # processed twice — mid-kernel evictions can unseat the first pass)
        for r in read_set + write_set:
            ids = touched[r.name]
            if ids is None:            # whole region: popcount fast path
                b = r.bytes_total
                nids = r.nchunks
            else:
                szs = r.sizes[ids]
                b = int(szs.sum())
                nids = len(ids)
            pinned_host = r.preferred is MemorySpace.HOST
            dup_flag = (r.read_mostly in (True, MAYBE) and r in read_set
                        and r not in write_set)
            if pinned_host and self.p.device_can_access_host:
                self.r_hi += b
                if r.counter_threshold is None:
                    # pure remote: provably no migration on this path
                    if ids is None:
                        self.r_lo += r.mask_bytes(~r.res_hi)
                    else:
                        self.r_lo += int(szs[~r.res_hi[ids]].sum())
                    continue
                # hybrid: any touched chunk may promote (fault + migrate)
            self.f_hi += nids
            if dup_flag and self.p.host_can_access_device:
                # pressured re-duplication faults at system-page granularity
                if ids is None:
                    n_pop = int(np.count_nonzero(r.pop_hi))
                    if n_pop:
                        per = max(1, r.chunk_bytes // self.p.page_bytes)
                        pages = per * n_pop
                        if r.pop_hi[-1]:
                            pages += (max(1, int(r.sizes[-1])
                                          // self.p.page_bytes) - per)
                        self.f_hi += pages - n_pop
                else:
                    pm = r.pop_hi[ids]
                    if pm.any():
                        pages = np.maximum(1, szs[pm] // self.p.page_bytes)
                        self.f_hi += int(pages.sum()) - int(pm.sum())
            if ids is None:
                self.hf_hi += r.mask_bytes(r.pop_hi)
            else:
                self.hf_hi += int(szs[r.pop_hi[ids]].sum())
            self._insert(nids, b)
            if ids is None:
                r.res_hi[:] = True
                r.pop_hi[:] = True
            else:
                r.res_hi[ids] = True
                r.pop_hi[ids] = True
            if dup_flag:
                r.dup_ever = True
        # ---- lower bounds: capacity pigeonhole over this kernel's touched
        # migrating bytes T (at most ``cap`` of T resident at kernel start;
        # mid-kernel removals are evictions only) + compulsory faults on
        # provably non-resident chunks
        T = 0
        T_pop = 0
        ev_lo = 0
        for nm in touched:
            r = self.regions[nm]
            if (r.preferred is MemorySpace.HOST
                    and self.p.device_can_access_host):
                continue            # remote or hybrid: migration not certain
            ids = touched[nm]
            if ids is None:
                T += r.bytes_total
                T_pop += r.mask_bytes(r.pop_lo)
                if int(np.count_nonzero(r.res_hi)) < r.nchunks:
                    ev_lo += self._n_events(r, np.flatnonzero(~r.res_hi))
            else:
                T += int(r.sizes[ids].sum())
                T_pop += int(r.sizes[ids[r.pop_lo[ids]]].sum())
                ev_lo += self._n_events(r, ids[~r.res_hi[ids]])
        over = max(0, T - cap)
        self.f_lo += max(ev_lo,
                         -(-over // self.p.fault_group_bytes) if over else 0)
        self.e_lo += -(-over // self.chunk_bytes) if over else 0
        self.hf_lo += max(0, T_pop - cap)
        if over and not any(r.dup_possible for r in self.regions.values()):
            # every evicted chunk is authoritative: write-back is certain
            self.d_lo += over
        # ---- eager restore (coherent fabrics under pressure): populated
        # chunks of device-pinned regions may be bulk-copied back after
        # every kernel — the paper's advise ping-pong
        if self.p.host_can_access_device:
            for r in self.regions.values():
                if r.preferred not in (MemorySpace.DEVICE, MAYBE):
                    continue
                cand = r.pop_hi
                b = r.mask_bytes(cand)
                if not b:
                    continue
                self.hb_hi += b
                self._insert(int(np.count_nonzero(cand)), b)
                r.res_hi |= cand
        # must-populated after the kernel: write-set touches
        for r in write_set:
            ids = touched[r.name]
            if ids is None:
                r.pop_lo[:] = True
                r.pop_hi[:] = True
            else:
                r.pop_lo[ids] = True
                r.pop_hi[ids] = True

    # -- result ----------------------------------------------------------------
    def bounds(self) -> CellBounds:
        p = self.p
        rate_f = p.link_bw_gbs * GB * p.fault_migration_efficiency
        rate_b = p.link_bw_gbs * GB
        rate_r = p.link_bw_gbs * GB * p.remote_access_efficiency
        if self.widened:
            evictions = (self.e_lo, self.ins_chunks)
            dtoh = (self.d_lo, self.d_hi + self.ins_bytes)
        else:
            evictions = (0, 0)
            dtoh = (self.d_lo, self.d_hi)
        xfer_lo = (self.hf_lo / rate_f + self.hb_lo / rate_b
                   + dtoh[0] / rate_b + self.r_lo / rate_r)
        xfer_hi = (self.hf_hi / rate_f + self.hb_hi / rate_b
                   + dtoh[1] / rate_b + self.r_hi / rate_r)
        return CellBounds(
            n_faults=(self.f_lo, self.f_hi),
            htod_bytes=(self.hf_lo + self.hb_lo, self.hf_hi + self.hb_hi),
            dtoh_bytes=dtoh,
            n_evictions=evictions,
            xfer_s=(xfer_lo, xfer_hi),
            exact=not self.widened,
        )


# -- entry points --------------------------------------------------------------

def workload_bounds(workload, strategy, platform,
                    granularity: str = "group") -> CellBounds | None:
    """Bound one (workload, strategy, platform, granularity) cell by
    driving the strategy's own lowering over the abstract domain.  Returns
    None when the cell is N/A (platform gate, or the explicit tier raising
    ``OversubscriptionError`` — mirrored abstractly, so a None bound pairs
    exactly with the harness's None report)."""
    from repro_torch.umbench import platforms as plat
    from repro_torch.umbench import variants as var
    p = plat.PLATFORMS[platform] if isinstance(platform, str) else platform
    strat = (var.get_strategy(strategy) if isinstance(strategy, str)
             else strategy)
    if not strat.available(p):
        return None
    asim = AbstractSim(p, granularity, strat.static_summary())
    try:
        strat.lower(workload, asim)
    except OversubscriptionError:
        return None
    return asim.bounds()


def ops_bounds(ops, strategy, platform,
               granularity: str = "group") -> CellBounds | None:
    """Bound a recorded op stream (``analysis.trace.Op`` objects — e.g. a
    serving cell's recording) by replaying it over the abstract domain.
    Scheduler decisions are baked into the stream, so no strategy lowering
    runs; the strategy only contributes its static summary (adaptive
    widening)."""
    from repro_torch.umbench import platforms as plat
    from repro_torch.umbench import variants as var
    p = plat.PLATFORMS[platform] if isinstance(platform, str) else platform
    strat = (var.get_strategy(strategy) if isinstance(strategy, str)
             else strategy)
    asim = AbstractSim(p, granularity, strat.static_summary())
    try:
        for op in ops:
            getattr(asim, op.name)(*op.args, **dict(op.kwargs))
    except OversubscriptionError:
        return None
    return asim.bounds()


def bounds_for_cell(app, strategy, platform, regime,
                    granularity: str = "group") -> CellBounds | None:
    """Bound a matrix cell given the harness's cell key: a string ``app``
    is sized to the regime's fraction of device memory exactly like
    ``harness.run_cell`` (a Workload object passes through)."""
    from repro_torch.umbench import platforms as plat
    p = plat.PLATFORMS[platform] if isinstance(platform, str) else platform
    workload = app
    if isinstance(app, str):
        from repro_torch.umbench.harness import REGIMES, WORKLOADS
        workload = WORKLOADS[app](REGIMES[regime] * p.device_mem_gb * GB)
    return workload_bounds(workload, strategy, p, granularity)


def verify_cell(cell) -> list[str]:
    """Cross-check one harness ``CellResult`` against its static bounds.
    Clean, reported cells only: failure records have nothing to check and
    fault-injected cells are deliberately amplified.  Returns violation
    strings (empty == consistent)."""
    if cell.report is None or cell.error is not None or cell.faults is not None:
        return []
    b = bounds_for_cell(cell.app, cell.variant, cell.platform, cell.regime,
                        cell.granularity)
    if b is None:
        return [f"cell has a report but bounds say N/A "
                f"({cell.app}/{cell.variant}/{cell.platform}/{cell.regime})"]
    return b.check(cell.report)
