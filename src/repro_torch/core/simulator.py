"""UMSimulator: discrete-event model of CUDA Unified Memory (paper §II).

The port's copy of ``repro.core.simulator`` (which imports no JAX), held
against it counter for counter by tests/test_torch_simulator.py.  It is
NumPy on the host, as the reference is: it models the device's memory and
launches nothing on the card.  The paper's fault-level behaviour is
reproduced here: a page/chunk-granular model of

  * on-demand migration driven by page faults, resolved in *fault groups*
    (paper §II-A; Sakharnykh'17 describes density-based block migration —
    baseline UM migrates in large groups, we default to 2 MB),
  * LRU eviction under oversubscription (paper §II-D; approximated by FIFO
    residency order, exact for the streaming sweeps our apps perform),
  * the three memory advises (paper §II-B) with the mechanisms the paper
    identifies:
      - READ_MOSTLY: read-duplicate pages on the faulting side.  Evicting a
        duplicate is FREE (drop, host copy valid); evicting a migrated page
        always costs a DtoH transfer (UM *moves* pages, so even clean pages
        must be copied back).  Duplication fault cost is platform-dependent
        (calibrated to the paper's cross-platform findings, DESIGN.md §2):
          * PCIe platforms: the driver's density heuristic resolves
            duplication in full fault groups (2 MB) — same fault count as
            migration, so advise is ~neutral in-memory and *wins*
            oversubscribed (dropped evictions).
          * Coherent fabrics (P9/NVLink ATS, Grace Hopper C2C): duplication
            skips the host unmap/TLB-shootdown, halving fault latency
            in-memory (advise wins), BUT under memory pressure the block
            heuristic is disabled and re-duplication faults at system page
            granularity (64 KB) — the fault explosion the paper traces in
            Fig. 7c/8c.
      - PREFERRED_LOCATION: pins pages; under memory pressure pinned pages
        are evicted only as a last resort (CUDA treats the advise as a hint).
        If the accessor cannot remote-map the target memory, falls back to
        migration (paper: "the page will be migrated as in the standard UM").
      - ACCESSED_BY: establishes a remote mapping (no fault, no migration)
        when the platform's interconnect supports that direction
        (host->device only on NVLink/P9; device->host also on PCIe).
  * asynchronous bulk prefetch (paper §II-C): full-bandwidth transfer on a
    background copy stream, zero fault latency, overlapped with compute,
  * Grace-Hopper-style access counters (DESIGN.md §10; Schieffer et al.,
    'Harnessing Integrated CPU-GPU System Memory for HPC'): a host-pinned
    region armed via ``enable_access_counters`` is accessed remotely until a
    chunk's per-chunk counter reaches the threshold, at which point the
    chunk is promoted — migrated through the normal fault/copy accounting —
    and participates in normal LRU eviction thereafter.

Timing model: one device (compute) stream and one copy stream.  Page faults
stall the compute stream (massive parallelism means a faulting kernel makes
no progress — paper §II-A).  The report exposes the same breakdown as the
paper's Fig. 4/7: compute, fault stall, HtoD time, DtoH time.

Implementation (DESIGN.md §3/§9): per-region chunk state is NumPy arrays
(``on_device`` / ``duplicated`` / ``populated`` / ``arrival`` / ``stamp``),
residency order lives in an incrementally maintained, run-coalesced
``ResidencyIndex`` (two append-ordered run queues mirroring the seed's
OrderedDicts — nothing is gathered or sorted per eviction plan), and every
public call processes whole chunk-index runs with batched fault-group,
transfer-time, and eviction accounting.  The seed per-chunk model is
preserved verbatim in the reference's ``repro.core.seed_simulator`` and
tests/test_simulator_parity.py proves the two agree counter-for-counter.
Rare orderings the batched plan cannot express (lazy pin reclassification)
fall back to exact scalar paths.

Granularity: ``UMSimulator(..., granularity="page")`` allocates at the
64 KB system-page size instead of the 2 MB fault group, modelling the
coherent-fabric fault explosion *directly* (one fault per page under
pressure) instead of via the seed's ``size // page_bytes`` shortcut.  Fault
events outside the pressure path coalesce per 2 MB group span so in-memory
fault counts stay comparable across granularities.

Robustness layer (DESIGN.md §12): ``set_fault_injector`` attaches a seeded
``repro_torch.core.faults.FaultInjector`` that degrades transfer events and
amplifies fault batches; every injection site is behind an
``if self._inj is not None`` guard, so the engine is bit-identical to the
pre-injection code path when no injector is attached.  Independently,
``SimReport.thrash`` records a rolling per-kernel fault/eviction-rate
window (always on, zero numeric effect) that the adaptive variant tiers
read to detect thrash and degrade gracefully.
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Mapping

import numpy as np

from repro_torch.core.advise import Accessor, MemorySpace
from repro_torch.core.residency import (
    ResidencyIndex,
    chunk_runs,
    counter_promote_split,
    expand_m_segs,
    expand_runs,
    merge_pop_runs,
)

KB = 1024
MB = 1024 * KB
GB = 1024 * MB


@dataclasses.dataclass(frozen=True)
class SimPlatform:
    """Hardware model. Bandwidths GB/s, latencies microseconds."""

    name: str
    device_mem_gb: float
    link_bw_gbs: float              # host<->device migration/copy bandwidth
    device_bw_gbs: float            # local device memory bandwidth
    device_flops_tps: float         # device compute throughput (TFLOP/s)
    fault_latency_us: float         # per fault-group handling cost
    host_can_access_device: bool    # NVLink/P9: CPU can map device memory
    device_can_access_host: bool    # zero-copy: GPU can map host memory
    fault_group_bytes: int = 2 * MB  # density-based migration block (baseline)
    page_bytes: int = 64 * KB        # duplication/eviction accounting page
    remote_access_efficiency: float = 0.7  # remote word access vs streamed copy
    # fault-driven migration reaches only a fraction of link bandwidth
    # (driver round-trips, small transfers, SM stalls — Sakharnykh GTC'17;
    # the paper's Fig. 5 shows fault-driven transfers far below bulk rate).
    # ATS fabrics fare much better than PCIe fault handling.
    fault_migration_efficiency: float = 1.0


class Region:
    """Chunk-granular state of one managed allocation, as NumPy arrays.

    ``on_device`` is the authoritative-copy location (seed ``loc``);
    ``duplicated`` marks read-mostly device duplicates (host copy valid);
    ``stamp``/``in_pin_queue`` encode the residency order for the scalar
    anomaly path (see residency.victim_order); ``arrival`` is the
    copy-stream completion time of in-flight prefetches.  A chunk is
    device-resident iff ``on_device | duplicated``.

    Residency-queue membership is run-coalesced (DESIGN.md §9):
    ``entry_ptr[i]`` points at the chunk's live run entry in the simulator's
    :class:`~repro_torch.core.residency.ResidencyIndex` (encoded ``entry * 2 +
    queue``, -1 when not filed), and ``q_live`` counts this region's live
    chunks per queue — the O(regions) pin-reclassification anomaly check
    that used to require gathering every resident chunk.
    """

    def __init__(self, name: str, nbytes: int, role: str = "data",
                 chunk_bytes: int = 2 * MB):
        self.name = name
        self.nbytes = int(nbytes)
        self.role = role
        self.chunk_bytes = int(chunk_bytes)
        # advise state
        self.read_mostly = False
        self.preferred: MemorySpace | None = None
        self.accessed_by: tuple[Accessor, ...] = ()
        # access-counter state (DESIGN.md §10): armed by
        # enable_access_counters; touch_count is allocated lazily so the
        # page-granularity sweeps of counter-less variants stay flat
        self.counter_threshold: float | None = None
        self.touch_count: np.ndarray | None = None
        # chunks whose device copy was installed by an explicit prefetch
        # call (lazily allocated, §11 overlap accounting): arrival waits on
        # these count as prefetch_wait_s; eager-restore copies do not
        self.pf_mark: np.ndarray | None = None
        # rotating cursor for partial (data-dependent) accesses, e.g. BFS
        self.cursor = 0
        n = max(1, math.ceil(self.nbytes / self.chunk_bytes))
        self.nchunks = n
        sizes = np.full(n, self.chunk_bytes, dtype=np.int64)
        rem = self.nbytes - (n - 1) * self.chunk_bytes
        sizes[-1] = rem if rem > 0 else self.chunk_bytes
        self.sizes = sizes
        self.bytes_total = int(sizes.sum())
        # cached arange(nchunks) — every full (non-partial) kernel touch of
        # this region reuses it instead of re-allocating a megachunk array
        self.all_ids: np.ndarray | None = None
        self.on_device = np.zeros(n, dtype=bool)
        self.duplicated = np.zeros(n, dtype=bool)
        # monotone flag: False guarantees ``duplicated`` is all-False, so
        # the eviction paths skip their per-victim duplicated-flag scans
        # entirely for regions that never held a read-mostly duplicate
        self.dup_ever = False
        self.populated = np.zeros(n, dtype=bool)
        self.arrival = np.zeros(n, dtype=np.float64)
        self.stamp = np.zeros(n, dtype=np.int64)
        self.in_pin_queue = np.zeros(n, dtype=bool)
        self.entry_ptr = np.full(n, -1, dtype=np.int64)
        self.q_live = [0, 0]        # live chunks in (unpinned, pinned) queue
        self.slot = -1              # position in the simulator's region list

    def chunk_size(self, idx: int) -> int:
        return int(self.sizes[idx])

    def resident_mask(self) -> np.ndarray:
        return self.on_device | self.duplicated

    def device_resident(self, idx: int) -> bool:
        return bool(self.on_device[idx] or self.duplicated[idx])


class ThrashWindow:
    """Rolling per-kernel fault/eviction-rate window (DESIGN.md §12).

    The simulator feeds its cumulative fault/eviction counters through
    :meth:`observe` at the end of every kernel launch; the window keeps the
    last ``size`` per-launch *deltas* (faults and evictions attributable to
    that launch, including eviction traffic from prefetches issued since
    the previous launch).  :meth:`thrashing` — any eviction inside the
    window — is the adaptive tiers' degradation trigger: eviction is the
    unambiguous memory-pressure signal (in-memory traces never evict, which
    is what pins the adaptive tiers bit-identical to their static bases on
    thrash-free traces).  Recording is always on and affects no simulated
    number, so it cannot perturb engine parity.
    """

    SIZE = 4

    def __init__(self, size: int = SIZE):
        self.size = int(size)
        self.samples: collections.deque = collections.deque(maxlen=self.size)
        self._last = (0, 0)
        self.n_thrash_steps = 0     # launches observed while thrashing

    def observe(self, n_faults: int, n_evictions: int) -> None:
        df = n_faults - self._last[0]
        de = n_evictions - self._last[1]
        self._last = (n_faults, n_evictions)
        self.samples.append((df, de))
        if self.thrashing():
            self.n_thrash_steps += 1

    def fault_rate(self) -> float:
        """Mean faults per launch over the window (0 when empty)."""
        if not self.samples:
            return 0.0
        return sum(s[0] for s in self.samples) / len(self.samples)

    def eviction_rate(self) -> float:
        """Mean evictions per launch over the window (0 when empty)."""
        if not self.samples:
            return 0.0
        return sum(s[1] for s in self.samples) / len(self.samples)

    def thrashing(self) -> bool:
        return any(s[1] for s in self.samples)


@dataclasses.dataclass
class SimReport:
    """Same decomposition as the paper's Fig. 4/7 stacked bars."""

    compute_s: float = 0.0
    fault_stall_s: float = 0.0      # fault-group handling latency (stall)
    htod_s: float = 0.0             # time moving data host->device
    dtoh_s: float = 0.0             # time moving data device->host
    remote_s: float = 0.0           # time in remote (mapped) accesses
    htod_bytes: int = 0
    dtoh_bytes: int = 0
    remote_bytes: int = 0
    n_faults: int = 0               # fault groups handled
    n_evictions: int = 0            # chunks evicted
    n_dropped: int = 0              # duplicate chunks dropped free of charge
    n_promotions: int = 0           # chunks migrated by access counters (§10)
    promoted_bytes: int = 0         # the counter-promoted (hot) working set
    # copy/compute overlap accounting (DESIGN.md §11; vectorized engine
    # only — the seed oracle predates the fields and leaves them 0):
    prefetch_copy_s: float = 0.0    # HtoD busy time of prefetch-issued
    #                                 copies on the async copy stream
    prefetch_wait_s: float = 0.0    # compute-stream stalls waiting on
    #                                 in-flight async-copy arrivals
    prefetch_overlap_s: float = 0.0  # prefetch copy time hidden under
    #                                  compute = copy_s - wait_s, >= 0
    # fault-injection accounting (DESIGN.md §12; vectorized engine only,
    # all 0 unless a FaultInjector is attached — the seed oracle and every
    # injector-free run leave them untouched):
    n_retries: int = 0              # failed transfer attempts, retried
    retry_stall_s: float = 0.0      # backoff latency charged to the streams
    n_degraded_xfers: int = 0       # transfer events inside degraded windows
    n_storm_faults: int = 0         # extra fault events from storm windows
    total_s: float = 0.0

    def __post_init__(self):
        # rolling fault/eviction-rate window, recorded at the end of every
        # kernel launch (always on, zero numeric effect — the adaptive
        # tiers' thrash-detection input).  A plain attribute, not a field:
        # it is runtime state, and must stay invisible to asdict()/== so
        # the field-by-field parity oracles keep comparing pure numbers.
        self.thrash = ThrashWindow()

    def breakdown(self) -> dict[str, float]:
        return {
            "compute": self.compute_s,
            "fault_stall": self.fault_stall_s,
            "htod": self.htod_s,
            "dtoh": self.dtoh_s,
            "remote": self.remote_s,
        }

    def to_json_dict(self) -> dict:
        """Full-precision numeric fields — the sweep journal's on-disk form
        (``thrash`` is a plain runtime attribute, never serialized)."""
        return dataclasses.asdict(self)

    @classmethod
    def from_json_dict(cls, d: Mapping) -> "SimReport":
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


class OversubscriptionError(RuntimeError):
    """Raised by the *explicit* variant when data cannot fit (paper: 'the
    case does not exist with original versions with explicit allocation')."""


GRANULARITIES = ("group", "page")


class UMSimulator:
    """Public surface (DESIGN.md §8): ``alloc``, the three ``advise_*`` calls,
    ``enable_access_counters``, ``explicit_*`` staging, ``prefetch``,
    ``host_write``/``host_read``, ``kernel``, ``finish``.  Advise *policy*
    lives above the simulator — the
    variant strategies in ``umbench.variants`` decide which advises to issue
    (role-based ``AdvisePolicy`` included); the simulator only executes them.
    """

    def __init__(self, platform: SimPlatform, granularity: str = "group",
                 audit: bool = False):
        if granularity not in GRANULARITIES:
            raise ValueError(f"granularity must be one of {GRANULARITIES}")
        self.p = platform
        self.granularity = granularity
        self.chunk_bytes = (platform.page_bytes if granularity == "page"
                            else platform.fault_group_bytes)
        self.regions: dict[str, Region] = {}
        self.report = SimReport()
        self.t_device = 0.0          # compute stream clock
        self.t_copy = 0.0            # copy stream clock
        self.device_used = 0         # bytes resident on device
        self._clock = 0              # residency-order stamp source
        # cached ramp buffers (grown on demand): 0-based/1-based int64 and
        # float64 aranges the megachunk hot paths slice instead of
        # re-allocating an arange per fault batch / bulk copy / stamp write
        self._ramp_cap = 0
        self._ramp_i0 = None
        self._ramp_i1 = None
        self._ramp_f0 = None
        self._ramp_f1 = None
        self._rlist: list[Region] = []      # regions in allocation order
        self._index = ResidencyIndex()      # run-coalesced residency queues
        # set once eviction has happened: the memory-pressure regime in which
        # coherent platforms lose the block-duplication heuristic (see header)
        self._pressure = False
        # fault injector (DESIGN.md §12): None means the robustness layer is
        # entirely absent — every injection site guards on this, so the
        # disabled engine is bit-identical to the pre-injection code path
        self._inj = None
        # engine invariant audit (DESIGN.md §14): opt-in, read-only checks
        # of the residency index after every public op.  None (the default)
        # costs one attribute test per op, and the checks only *read* state,
        # so audit=True is bit-identical to audit=False by construction
        # (tests/test_analysis_audit.py pins it numerically).
        self._audit = None
        if audit:
            from repro_torch.umbench.analysis.audit import check_invariants
            self._audit = check_invariants

    def _audited(self, op: str, region: str | None = None) -> None:
        """One guarded audit call site per public batched op."""
        if self._audit is not None:
            self._audit(self, op, region)

    def set_fault_injector(self, injector) -> None:
        """Attach a :class:`repro_torch.core.faults.FaultInjector` for this run.
        Must be called before the first simulated event; the injector's
        cumulative accounting is copied onto the report by ``finish``."""
        self._inj = injector

    # -- capacity ------------------------------------------------------------
    @property
    def device_capacity(self) -> int:
        return int(self.p.device_mem_gb * GB)

    # -- allocation & advises --------------------------------------------------
    def alloc(self, name: str, nbytes: int, role: str = "data") -> Region:
        if name in self.regions:
            raise ValueError(f"region {name} exists")
        r = Region(name, int(nbytes), role=role, chunk_bytes=self.chunk_bytes)
        r.slot = len(self._rlist)
        self._rlist.append(r)
        self.regions[name] = r
        self._audited("alloc", name)
        return r

    def free(self, name: str) -> None:
        """``cudaFree`` for a managed region: every device-resident chunk is
        released *without* a transfer — the data is discarded, not migrated,
        so no clock moves and nothing is charged to dtoh — and the name is
        forgotten.  The dead Region keeps its slot in the allocation list
        (residency-index run entries encode region slots), but with no live
        queue entries it can never be chosen as an eviction victim.  The
        serving tier (umbench/serving) retires each request's KV blocks
        through here as the request leaves the running batch."""
        r = self.regions.pop(name)
        ids = np.nonzero(r.resident_mask())[0]
        if len(ids):
            self.device_used -= int(r.sizes[ids].sum())
            self._index_remove(r, ids)
            r.on_device[ids] = False
            r.duplicated[ids] = False
            self._pf_clear(r, ids)
        r.populated[:] = False
        self._audited("free", name)

    def advise_read_mostly(self, name: str) -> None:
        self.regions[name].read_mostly = True
        self._audited("advise_read_mostly", name)

    def advise_preferred_location(self, name: str, space: MemorySpace) -> None:
        r = self.regions[name]
        r.preferred = space
        # Virgin (never-written) pages are *created* at the preferred
        # location when the host can address it (coherent fabrics): the
        # host then initializes device-resident pages via remote writes —
        # the paper's P9 in-memory win for CG/FDTD (§IV-A).
        if space is MemorySpace.DEVICE and self.p.host_can_access_device:
            cand = np.nonzero(~r.populated & ~r.resident_mask())[0]
            if len(cand):
                free = self.device_capacity - self.device_used
                csum = np.cumsum(r.sizes[cand])
                # placement preference, not a guarantee: stop at the first
                # candidate that does not fit
                k = int(np.searchsorted(csum, free, side="right"))
                if k:
                    self._insert_resident(r, cand[:k], duplicate=False)
        self._audited("advise_preferred_location", name)

    def advise_accessed_by(self, name: str, accessor: Accessor) -> None:
        r = self.regions[name]
        r.accessed_by = r.accessed_by + (accessor,)
        self._audited("advise_accessed_by", name)

    # -- advise withdrawal (the adaptive tiers' degradation ops, §12) ----------
    def unadvise_read_mostly(self, name: str) -> None:
        """Withdraw READ_MOSTLY: stop duplicating on future reads and drop
        existing device duplicates for free — the host copy is valid, so
        there is only device memory to release (the same free-drop
        ``prefetch``-to-host performs).  Under eviction pressure this is the
        graceful exit from the paper's P9 re-duplication pathology."""
        r = self.regions[name]
        r.read_mostly = False
        dup_ids = np.nonzero(r.duplicated)[0]
        if len(dup_ids):
            r.duplicated[dup_ids] = False
            gone = dup_ids[~r.on_device[dup_ids]]
            if len(gone):
                self.device_used -= int(r.sizes[gone].sum())
                self.report.n_dropped += len(gone)
                self._index_remove(r, gone)
                self._pf_clear(r, gone)
        self._audited("unadvise_read_mostly", name)

    def unadvise_preferred_location(self, name: str) -> None:
        """Withdraw PREFERRED_LOCATION: pages are no longer pinned (and no
        longer eagerly restored on coherent fabrics).  Resident chunks
        filed in the pinned queue are re-filed at the unpinned tail in
        residency-stamp order — the batched equivalent of the seed's lazy
        pop-time reclassification, applied eagerly so sweeps never fall
        into the O(chunks)-per-pop scalar anomaly path."""
        r = self.regions[name]
        if r.preferred is None:
            return
        r.preferred = None
        if r.q_live[1]:
            # the region's live pinned chunks in stamp order, read off the
            # pin queue directly: entries are in stamp order and within an
            # entry ascending id IS ascending stamp (see RunQueue.front) —
            # no per-chunk stamp argsort
            q = self._index.pin
            parts = []
            for e in range(q.head, q.tail):
                if int(q.nlive[e]) == 0 or int(q.reg[e]) != r.slot:
                    continue
                s, ln = int(q.start[e]), int(q.length[e])
                if int(q.nlive[e]) == ln:
                    parts.append(np.arange(s, s + ln, dtype=np.int64))
                else:
                    win = r.entry_ptr[s:s + ln]
                    parts.append(s + np.nonzero(win == e * 2 + 1)[0])
            ids = np.concatenate(parts)     # q_live[1] > 0: never empty
            self._index_remove(r, ids, clear=False)
            r.in_pin_queue[ids] = False
            self._stamp_ids(r, ids)
            self._index_append(r, ids, qi=0)
        self._audited("unadvise_preferred_location", name)

    def enable_access_counters(self, name: str, threshold: float) -> None:
        """Arm Grace-Hopper-style per-chunk access counters (DESIGN.md §10)
        on a host-pinned region: device-side remote accesses increment a
        per-chunk counter, and a chunk's ``threshold``-th touch promotes it
        — migrates it through the normal fault/copy accounting, after which
        it participates in normal LRU eviction.  ``threshold`` may be 0 (or
        1: promote on first touch — on-demand UM) through ``math.inf``
        (never promote — the pure remote tier).  Counters only gate the
        kernel remote-access path; host I/O and explicit/prefetch staging
        are unaffected."""
        if threshold < 0:
            raise ValueError(f"counter threshold must be >= 0: {threshold}")
        r = self.regions[name]
        r.counter_threshold = float(threshold)
        if r.touch_count is None:
            r.touch_count = np.zeros(r.nchunks, dtype=np.int64)
        self._audited("enable_access_counters", name)

    # -- residency bookkeeping -------------------------------------------------
    def _stamps(self, n: int) -> np.ndarray:
        s = np.arange(self._clock, self._clock + n, dtype=np.int64)
        self._clock += n
        return s

    def _ramps(self, n: int) -> None:
        """Ensure the cached ramp buffers cover ``n`` elements.  The views
        ``_ramp_i0[:n]``/``_ramp_i1[:n]`` hold 0..n-1 / 1..n (int64) and
        ``_ramp_f0``/``_ramp_f1`` their float64 twins — read-only by
        convention; consumers multiply/add them into fresh or out= arrays."""
        if n <= self._ramp_cap:
            return
        cap = max(2 * self._ramp_cap, n)
        self._ramp_i0 = np.arange(cap, dtype=np.int64)
        self._ramp_i1 = self._ramp_i0 + 1
        self._ramp_f0 = self._ramp_i0.astype(np.float64)
        self._ramp_f1 = self._ramp_i1.astype(np.float64)
        self._ramp_cap = cap

    def _stamp_run(self, r: Region, s0: int, n: int) -> None:
        """Stamp the contiguous run ``[s0, s0+n)`` with the next ``n`` clock
        values in one fused pass (no arange allocation + copy).

        Stamps are *audit-only* state: every engine reader of pop order
        (the run planner, the scalar anomaly path, the pinned-queue
        re-sort) reads queue order, which IS stamp order — so with the
        audit off the per-chunk write (8 bytes x millions of pages per
        insert) is skipped and only the clock advances, keeping audit-on
        stamps bit-identical to what they always were."""
        if self._audit is not None:
            self._ramps(n)
            np.add(self._ramp_i0[:n], self._clock, out=r.stamp[s0:s0 + n])
        self._clock += n

    def _stamp_ids(self, r: Region, ids: np.ndarray) -> None:
        """Gathered-id counterpart of :meth:`_stamp_run` (audit-only write,
        clock always advances)."""
        if self._audit is not None:
            r.stamp[ids] = self._stamps(len(ids))
        else:
            self._clock += len(ids)

    def _index_append(self, r: Region, ids: np.ndarray,
                      qi: int | None = None) -> None:
        """File ``ids`` (already stamped, ``in_pin_queue`` set) at the tail
        of their queue as coalesced runs, in ``ids`` order.  Callers that
        just wrote a uniform ``in_pin_queue`` value pass ``qi`` so the
        single-queue membership check never re-scans the window."""
        n = len(ids)
        s0 = int(ids[0])
        contig = n == 1 or int(ids[-1]) - s0 == n - 1
        if qi is None and contig \
                and bool((r.in_pin_queue[s0:s0 + n]
                          == r.in_pin_queue[s0]).all()):
            qi = 1 if r.in_pin_queue[s0] else 0
        if qi is not None:
            # single-queue batch: slice views instead of fancy gathers (the
            # hot page-granularity fault/insert path)
            starts, lengths, csizes = chunk_runs(
                ids, r.sizes[s0:s0 + n] if contig else r.sizes[ids])
            self._index.queue(qi).append(r.slot, starts, lengths, csizes,
                                         self._rlist)
            r.q_live[qi] += n
            return
        pinq = r.in_pin_queue[ids]
        for qi in (0, 1):
            sub = ids[pinq] if qi else ids[~pinq]
            if not len(sub):
                continue
            starts, lengths, csizes = chunk_runs(sub, r.sizes[sub])
            self._index.queue(qi).append(r.slot, starts, lengths, csizes,
                                         self._rlist)
            r.q_live[qi] += len(sub)

    def _one_entry(self, r: Region, ids: np.ndarray) -> int:
        """Entry code shared by every chunk of ``ids``, or -1.  For an
        ascending contiguous batch whose candidate entry is fully live the
        check is O(1) — matching endpoints inside a fully-live window imply
        the whole batch is filed there — so the hot per-kernel re-touch of a
        megachunk region never gathers ``entry_ptr``."""
        n = len(ids)
        s0 = int(ids[0])
        e0 = int(r.entry_ptr[s0])
        if n == 1:
            return e0
        if int(ids[-1]) - s0 == n - 1:
            if int(r.entry_ptr[s0 + n - 1]) != e0:
                return -1
            if e0 >= 0:
                q = self._index.queue(e0 & 1)
                if int(q.nlive[e0 >> 1]) == int(q.length[e0 >> 1]):
                    return e0
            return e0 if bool((r.entry_ptr[s0:s0 + n] == e0).all()) else -1
        enc = r.entry_ptr[ids]
        if e0 == int(enc[-1]) and (enc == e0).all():
            return e0
        return -1

    def _index_remove(self, r: Region, ids: np.ndarray,
                      clear: bool = True) -> None:
        """Un-file ``ids`` from their queue entries (lazy run shrink).
        ``clear=False`` skips the ``entry_ptr`` invalidation pass — only
        for callers that immediately re-file the exact same ids (the
        append overwrites every cleared slot anyway)."""
        n = len(ids)
        e0 = self._one_entry(r, ids)
        if e0 >= 0:
            # fast path: one entry covers the whole batch (the common case —
            # batches are runs, runs live in one entry)
            if int(ids[-1]) - int(ids[0]) == n - 1:
                s0 = int(ids[0])
                if clear:
                    r.entry_ptr[s0:s0 + n] = -1
                lo, hi = s0, s0 + n - 1
            else:
                if clear:
                    r.entry_ptr[ids] = -1
                lo, hi = int(ids.min()), int(ids.max())
            qi = e0 & 1
            self._index.queue(qi).remove(e0 >> 1, n, lo, hi)
            r.q_live[qi] -= n
            return
        if n > 1 and int(ids[-1]) - int(ids[0]) == n - 1:
            # contiguous multi-entry window (the bulk-eviction shape):
            # entry codes along the window are piecewise-constant runs —
            # an entry's span is contiguous, so its members inside a
            # contiguous window form consecutive blocks.  Group at run
            # boundaries and aggregate per code instead of gathering and
            # argsorting the (possibly megachunk) window; the per-entry
            # (cnt, id_min, id_max) triples — and the sorted-code call
            # order — are exactly the scatter path's.
            s0 = int(ids[0])
            enc = r.entry_ptr[s0:s0 + n]
            cuts = np.flatnonzero(np.diff(enc) != 0) + 1
            starts = np.concatenate([[0], cuts])
            ends = np.concatenate([cuts, [n]])
            codes = enc[starts]
            if clear:
                r.entry_ptr[s0:s0 + n] = -1
            groups: dict[int, list] = {}
            for a, b, e in zip(starts.tolist(), ends.tolist(),
                               codes.tolist(), strict=True):
                g = groups.get(e)
                if g is None:
                    groups[e] = [b - a, a, b]
                else:
                    g[0] += b - a
                    g[2] = b
            for e in sorted(groups):
                cnt, a, b = groups[e]
                qi = e & 1
                self._index.queue(qi).remove(e >> 1, cnt, s0 + a,
                                             s0 + b - 1)
                r.q_live[qi] -= cnt
            return
        enc = r.entry_ptr[ids]
        if clear:
            r.entry_ptr[ids] = -1
        order = np.argsort(enc, kind="stable")
        enc_s = enc[order]
        ids_s = ids[order]
        bounds = np.concatenate(
            [[0], np.flatnonzero(np.diff(enc_s) != 0) + 1, [len(enc_s)]])
        for a, b in zip(bounds[:-1].tolist(), bounds[1:].tolist()):
            e = int(enc_s[a])
            grp = ids_s[a:b]
            qi = e & 1
            self._index.queue(qi).remove(e >> 1, b - a, int(grp.min()),
                                         int(grp.max()))
            r.q_live[qi] -= b - a

    @staticmethod
    def _pf_clear(r: Region, ids: np.ndarray) -> None:
        """Forget prefetch attribution for chunks leaving the device: their
        next device copy is whoever re-installs them (fault or eager
        restore), not the original prefetch (§11 overlap accounting)."""
        if r.pf_mark is not None and len(ids):
            r.pf_mark[ids] = False

    def _queue_anomaly(self) -> bool:
        """True when any region holds live chunks filed under a queue that
        disagrees with its *current* pin state — the seed reclassifies such
        chunks lazily at pop time, so callers must take the scalar path.
        O(regions), replacing the old per-chunk ``in_pin_queue != pnow``
        scan over a full gather."""
        for r in self._rlist:
            pinned = r.preferred is MemorySpace.DEVICE
            if r.q_live[1 if not pinned else 0]:
                return True
        return False

    def _pop_runs(self):
        return self._index.pop_runs(self._rlist)

    def _expand_victims(self, regs, starts, cnts, csz, upto: int | None = None):
        """Expand victim runs (pop order) to per-chunk arrays
        (reg_ids, chunk_ids, sizes, dups), optionally only the first
        ``upto`` chunks."""
        if upto is not None:
            ccum = np.cumsum(cnts)
            j = int(np.searchsorted(ccum, upto, side="left"))
            prev = int(ccum[j - 1]) if j else 0
            regs = regs[:j + 1]
            starts = starts[:j + 1]
            cnts = cnts[:j + 1].copy()
            csz = csz[:j + 1]
            cnts[j] = upto - prev
        reg_ids = np.repeat(regs, cnts)
        chunk_ids = expand_runs(starts, cnts)
        sizes = np.repeat(csz, cnts)
        dups = np.empty(len(chunk_ids), dtype=bool)
        pos = 0
        for k in range(len(regs)):
            c = int(cnts[k])
            r = self._rlist[int(regs[k])]
            s = int(starts[k])
            if r.dup_ever:
                dups[pos:pos + c] = r.duplicated[s:s + c]
            else:
                dups[pos:pos + c] = False
            pos += c
        return reg_ids, chunk_ids, sizes, dups

    def _insert_resident(self, r: Region, ids: np.ndarray, *, duplicate) -> None:
        """Batch _mark_resident for chunks known to be non-resident.

        ``duplicate`` is a scalar bool or a per-chunk bool array.  Stamps are
        assigned in ``ids`` order — exactly the seed's insertion order — and
        the chunks are filed at the tail of their residency queue.
        """
        n = len(ids)
        s0 = int(ids[0])
        # contiguous batches (every fault/copy run) write through slices —
        # no index-array gathers on the megachunk page-granularity path
        contig = int(ids[-1]) - s0 == n - 1
        sl = slice(s0, s0 + n) if contig else ids
        csz = int(r.sizes[s0])
        if contig and (n < 2 or int(r.sizes[s0 + n - 2]) == csz):
            # uniform run (odd tail at most): byte total is scalar
            self.device_used += (n - 1) * csz + int(r.sizes[s0 + n - 1])
        else:
            self.device_used += int(r.sizes[sl].sum())
        if contig:
            self._stamp_run(r, s0, n)
        else:
            self._stamp_ids(r, ids)
        pinned = r.preferred is MemorySpace.DEVICE
        r.in_pin_queue[sl] = pinned
        dup = np.asarray(duplicate, dtype=bool)
        if dup.ndim == 0:
            if bool(dup):
                r.duplicated[sl] = True
                r.dup_ever = True
            else:
                r.on_device[sl] = True
        elif contig:
            r.duplicated[sl] |= dup
            r.on_device[sl] |= ~dup
            if not r.dup_ever and bool(dup.any()):
                r.dup_ever = True
        else:
            r.duplicated[ids[dup]] = True
            r.on_device[ids[~dup]] = True
            if not r.dup_ever and bool(dup.any()):
                r.dup_ever = True
        self._index_append(r, ids, qi=1 if pinned else 0)

    def _touch(self, r: Region, ids: np.ndarray) -> None:
        """Move touched chunks to the back of their queue (seed move_to_end):
        re-stamping preserves relative order within each queue, and the
        index entries are re-filed at the tail of the same queue."""
        n = len(ids)
        e0 = self._one_entry(r, ids)
        if e0 >= 0:
            q = self._index.queue(e0 & 1)
            e = e0 >> 1
            if (e == q.tail - 1 and int(q.nlive[e]) == n
                    and int(ids[0]) == int(q.start[e])):
                # the batch IS the queue's whole tail entry, touched in the
                # entry's own ascending order (ids are ascending or
                # wrapped-ascending — see chunk_runs; a wrapped touch never
                # starts at the entry's first chunk): move_to_end preserves
                # order exactly, so skip the re-file (the common
                # steady-state re-touch of a resident region).  A wrapped
                # touch (partial kernel whose cursor sits mid-entry) falls
                # through and re-files in touch order, as the seed does.
                return
        s0 = int(ids[0])
        if int(ids[-1]) - s0 == n - 1:
            self._stamp_run(r, s0, n)
        else:
            self._stamp_ids(r, ids)
        self._index_remove(r, ids, clear=False)
        self._index_append(r, ids)

    def residency_snapshot(self) -> list[tuple[str, int]]:
        """(region name, chunk) pairs in queue-filed pop order — the
        unpinned queue then the pinned queue, exactly the seed's OrderedDict
        contents.  Test/introspection hook."""
        pop = self._pop_runs()
        if pop is None:
            return []
        regs, starts, cnts, _, _ = pop
        out: list[tuple[str, int]] = []
        for k in range(len(regs)):
            name = self._rlist[int(regs[k])].name
            s = int(starts[k])
            out.extend((name, i) for i in range(s, s + int(cnts[k])))
        return out

    def _debug_validate(self) -> None:
        """Index/state consistency invariants (tests only — O(chunks))."""
        live_bytes = 0
        for r in self._rlist:
            res = r.resident_mask()
            assert np.array_equal(res, r.entry_ptr >= 0), r.name
            filed_pin = r.in_pin_queue[res]
            assert r.q_live[0] == int((~filed_pin).sum()), r.name
            assert r.q_live[1] == int(filed_pin.sum()), r.name
            live_bytes += int(r.sizes[res].sum())
        assert live_bytes == self.device_used
        assert (self._index.un.live_bytes
                + self._index.pin.live_bytes) == live_bytes
        snap = self.residency_snapshot()
        assert len(snap) == self._index.live_chunks

    def _apply_evictions(self, rlist, reg_ids, chunk_ids, sizes, dups) -> None:
        """State + accounting for a batch of victims (order-independent:
        all per-victim effects are additive)."""
        n = len(chunk_ids)
        if not n:
            return
        self.device_used -= int(sizes.sum())
        self.report.n_evictions += n
        ndrop = int(dups.sum())
        self.report.n_dropped += ndrop
        if ndrop < n:
            msz = sizes if ndrop == 0 else sizes[~dups]
            t = float((msz / (self.p.link_bw_gbs * GB)).sum())
            if self._inj is not None:
                scale, backoff = self._inj.transfer(t)
                t *= scale
                self.t_device += backoff
            self.report.dtoh_s += t
            self.report.dtoh_bytes += int(msz.sum())
            # eviction write-back is on the critical path of the allocation
            # that triggered it
            self.t_device += t
        r0 = int(reg_ids[0])
        if r0 == reg_ids[-1] and (reg_ids == r0).all():
            groups = [(r0, slice(None))]       # single-region batch (common)
        else:
            groups = [(int(ri), reg_ids == ri) for ri in np.unique(reg_ids)]
        for ri, sel in groups:
            r = rlist[ri]
            ids = chunk_ids[sel]
            self._index_remove(r, ids)
            if ndrop == 0:
                r.on_device[ids] = False       # migrated back to host
            elif ndrop == n:
                r.duplicated[ids] = False      # free drop (host copy valid)
            else:
                d = dups[sel]
                r.duplicated[ids[d]] = False
                r.on_device[ids[~d]] = False
            self._pf_clear(r, ids)

    def _apply_eviction_runs(self, rlist, regs, starts, cnts, csz) -> None:
        """Run-level :meth:`_apply_evictions`: same state + accounting, but
        every per-victim effect is computed per run with slice reads/writes
        — no per-chunk expansion ever happens on this path (the hot
        page-granularity eviction path; integer counters stay exact because
        run chunk sizes are uniform, transfer seconds agree with the
        per-chunk sum to float rounding, inside the parity contract)."""
        n = int(cnts.sum())
        if not n:
            return
        self.device_used -= int((cnts * csz).sum())
        self.report.n_evictions += n
        bw = self.p.link_bw_gbs * GB
        t = 0.0
        mig_bytes = 0
        drops: list[tuple[Region, int, int]] = []
        for k in range(len(regs)):
            r = rlist[int(regs[k])]
            s, c = int(starts[k]), int(cnts[k])
            k_drop = int(r.duplicated[s:s + c].sum()) if r.dup_ever else 0
            if k_drop:
                self.report.n_dropped += k_drop
            mig = c - k_drop
            if mig:
                mb = mig * int(csz[k])
                mig_bytes += mb
                t += mb / bw
            drops.append((r, s, c))
        if mig_bytes:
            if self._inj is not None:
                scale, backoff = self._inj.transfer(t)
                t *= scale
                self.t_device += backoff
            self.report.dtoh_s += t
            self.report.dtoh_bytes += mig_bytes
            self.t_device += t
        self._index.remove_runs(rlist, regs, starts, cnts)
        for r, s, c in drops:
            if r.dup_ever:
                r.duplicated[s:s + c] = False  # free drop (host copy valid)
            r.on_device[s:s + c] = False       # migrated back to host
            if r.pf_mark is not None:
                r.pf_mark[s:s + c] = False

    def _evict_for(self, need: int) -> None:
        """Evict least-recently-resident chunks until `need` bytes fit.

        Non-pinned chunks go first; pinned (preferred-location DEVICE) chunks
        are a last resort, mirroring CUDA treating the advise as a hint.
        Duplicated (read-mostly) chunks are dropped for free; migrated chunks
        pay a DtoH transfer — UM *moves* pages, so the host has no copy.

        Victims come straight off the incremental index: a run-level cumsum
        finds the boundary run, and only the actual victims are ever
        expanded to chunks (the seed's pop loop, ``eviction_cut``-exact
        including exact-fit boundaries and the all-drained over-drain).
        """
        self._pressure = True
        need_free = self.device_used + need - self.device_capacity
        if need_free <= 0:
            return
        if self._queue_anomaly():
            self._evict_for_scalar(need)
            return
        pop = self._pop_runs()
        if pop is None:
            raise OversubscriptionError(f"cannot free {need} bytes")
        regs, starts, cnts, csz, _ = pop
        rcum = np.cumsum(cnts * csz)
        if int(rcum[-1]) < need_free:
            # over-drain: the seed pops *everything*, then raises
            self._apply_eviction_runs(self._rlist, regs, starts, cnts, csz)
            raise OversubscriptionError(f"cannot free {need} bytes")
        j = int(np.searchsorted(rcum, need_free, side="left"))
        prev = int(rcum[j - 1]) if j else 0
        within = -((prev - need_free) // int(csz[j]))   # ceil, >= 1
        t_cnts = cnts[:j + 1].copy()
        t_cnts[j] = within
        self._apply_eviction_runs(self._rlist, regs[:j + 1], starts[:j + 1],
                                  t_cnts, csz[:j + 1])

    def _evict_for_scalar(self, need: int) -> None:
        """Pop-by-pop eviction replicating the seed's lazy queue
        reclassification (a region's pin advise changed after its chunks
        were filed).  Only reached when the per-region queue counters flag
        an anomaly.  The victim comes straight off the index queues —
        queue order IS stamp order (the audited ``stamp_order``
        invariant), so the front of the unpinned queue (then the pinned
        one) is exactly the seed's argmin-stamp pop, with no per-chunk
        stamp gather."""
        while self.device_used + need > self.device_capacity:
            qi = 0
            f = self._index.un.front(self._rlist)
            if f is None:
                qi = 1
                f = self._index.pin.front(self._rlist)
            if f is None:
                raise OversubscriptionError(f"cannot free {need} bytes")
            rg, idx = f
            r = self._rlist[rg]
            pnow = r.preferred is MemorySpace.DEVICE
            if qi == 0 and pnow:             # advise changed since insert
                self._refile(r, idx, pinned=True)
                continue
            if qi == 1 and not pnow:         # un-pinned since insert
                self._refile(r, idx, pinned=False)
                continue
            dup = (np.array([bool(r.duplicated[idx])])
                   if r.dup_ever else np.zeros(1, dtype=bool))
            self._apply_evictions(self._rlist,
                                  np.array([rg], dtype=np.int64),
                                  np.array([idx], dtype=np.int64),
                                  np.array([int(r.sizes[idx])],
                                           dtype=np.int64), dup)

    def _refile(self, r: Region, idx: int, *, pinned: bool) -> None:
        """Move one chunk to the tail of the other queue (the seed's lazy
        pop-time reclassification), keeping the index in step."""
        one = np.array([idx])
        self._index_remove(r, one)
        r.in_pin_queue[idx] = pinned
        self._stamp_ids(r, one)
        self._index_append(r, one, qi=1 if pinned else 0)

    # -- fault-event coalescing -------------------------------------------------
    def _n_fault_events(self, r: Region, ids: np.ndarray) -> int:
        """Fault events for a set of faulting chunks.  At group granularity
        each chunk is one event (the seed model).  At page granularity the
        driver's density heuristic still resolves faults per 2 MB group span,
        so events coalesce — except on the pressure/duplication path, which
        bypasses this helper entirely (one fault per page: Fig. 7c/8c)."""
        if self.granularity == "group" or r.chunk_bytes >= self.p.fault_group_bytes:
            return len(ids)
        n = len(ids)
        i0, iN = int(ids[0]), int(ids[-1])
        if iN - i0 == n - 1:
            # contiguous run: consecutive chunks step the group id by 0 or 1
            # (chunk < group), so every group in [g(i0), g(iN)] is hit —
            # closed form, no np.unique over a megachunk id array
            cb, fg = r.chunk_bytes, self.p.fault_group_bytes
            return int((iN * cb) // fg - (i0 * cb) // fg) + 1
        groups = (ids.astype(np.int64) * r.chunk_bytes) // self.p.fault_group_bytes
        return len(np.unique(groups))

    # -- transfers ---------------------------------------------------------------
    def _fault_one(self, r: Region, idx: int, *, duplicate: bool) -> None:
        """Scalar fault path — seed `_fault_migrate` verbatim.  Used when the
        batched fault path cannot prove the seed's eviction interleaving
        (victims inside the faulting batch itself)."""
        size = int(r.sizes[idx])
        if self.device_used + size > self.device_capacity:
            self._evict_for(size)
        one = np.array([idx])
        if not r.populated[idx]:
            events = 1
            if self._inj is not None:
                events = self._inj.fault_events(1)
            stall = events * self.p.fault_latency_us * 1e-6
            self.t_device += stall
            self.report.fault_stall_s += stall
            self.report.n_faults += events
            r.populated[idx] = True
            self._insert_resident(r, one, duplicate=False)
            return
        groups = 1
        latency = self.p.fault_latency_us
        if duplicate and self.p.host_can_access_device:       # coherent fabric
            if self._pressure:
                groups = max(1, size // self.p.page_bytes)    # ATS 64K faults
            else:
                latency *= 0.5                                # no host unmap
        xfer = size / (self.p.link_bw_gbs * GB * self.p.fault_migration_efficiency)
        if self._inj is not None:
            groups = self._inj.fault_events(groups)
            scale, backoff = self._inj.transfer(xfer)
            xfer *= scale
            self.t_device += backoff
        stall = groups * latency * 1e-6
        self.t_device += stall + xfer
        self.report.fault_stall_s += stall
        self.report.htod_s += xfer
        self.report.htod_bytes += size
        self.report.n_faults += groups
        self._insert_resident(r, one, duplicate=duplicate)

    def _plan_victims(self, r: Region, ids: np.ndarray, need: np.ndarray,
                      own_dup: np.ndarray, want_m: bool = True):
        """Victim plan for inserting the batch ``ids`` into ``r``.

        ``need[i]`` is the byte deficit before chunk i's insertion.  Returns
        the victims in the seed's exact pop order — the old unpinned queue
        (stamp order) first, the old pinned queue last-resort, with the
        batch's own just-inserted chunks interleaved wherever the seed would
        pop them — plus ``m[i]``, the number of victims consumed before chunk
        i's insertion.  When the deficit is covered by a pure prefix of the
        old queues this is a run-level cumsum cut off the incremental index;
        otherwise ``residency.merge_pop_runs`` replays the seed's queue
        dynamics in O(runs) (own chunks join their region's queue as they
        are inserted and may be evicted by later chunks of the same batch —
        the streaming-thrash regime).  Either way only consumed victims are
        expanded to chunk granularity.  Returns None when pin
        reclassification anomalies exist or the deficit cannot be covered at
        all (the seed then raises); callers take the scalar path.
        """
        region_pinned = r.preferred is MemorySpace.DEVICE
        if self._queue_anomaly():
            return None
        pop = self._pop_runs()
        if pop is None:
            z = np.zeros(0, dtype=np.int64)
            q_regs, q_starts, q_cnts, q_csz, n_un_runs = z, z, z, z, 0
        else:
            q_regs, q_starts, q_cnts, q_csz, n_un_runs = pop
        n_own = len(ids)
        need_total = int(need[-1])
        un_bytes = self._index.un.live_bytes
        old_bytes = un_bytes + self._index.pin.live_bytes
        if need_total <= un_bytes or (region_pinned and need_total <= old_bytes):
            # pure old-queue prefix: no own-batch chunk can be popped before
            # the deficit is covered.  The victim set stays RUN-LEVEL — the
            # boundary run is cut at the exact victim count (runs are
            # size-uniform) and _apply_eviction_runs applies it with slice
            # arithmetic; per-chunk expansion happens only when the evicting
            # bulk copy needs non-uniform/duplicate write-back pricing.
            rcum = np.cumsum(q_cnts * q_csz)
            j = int(np.searchsorted(rcum, need_total, side="left"))
            prev = int(rcum[j - 1]) if j else 0
            within = -((prev - need_total) // int(q_csz[j]))   # ceil, >= 1
            t_regs = q_regs[:j + 1]
            t_starts = q_starts[:j + 1]
            t_cnts = q_cnts[:j + 1].copy()
            t_cnts[j] = within
            t_csz = q_csz[:j + 1]
            plan = {
                "rlist": self._rlist,
                "old_runs": (t_regs, t_starts, t_cnts, t_csz),
                "own_evicted": np.zeros(0, dtype=np.int64),
            }
            if want_m:
                # per-insert victim consumption — only the evicting async
                # bulk copy prices arrivals off it; fault batches skip it.
                # Runs with mixed duplicated flags are split at the flag
                # transitions into dup-uniform SUBRUNS (flag transitions are
                # rare: duplication is a per-advise region property), so m
                # and the write-back schedule are always piecewise linear
                # across subruns — a run-level searchsorted replaces the
                # per-chunk vcum/searchsorted over the whole victim set,
                # and no victim is ever expanded to chunk granularity here.
                s_cnts, s_csz, s_dup = [], [], []
                for k in range(len(t_regs)):
                    start, cnt = int(t_starts[k]), int(t_cnts[k])
                    rk = self._rlist[int(t_regs[k])]
                    if not rk.dup_ever:
                        s_cnts.append([cnt])
                        s_dup.append([False])
                        s_csz.append([int(t_csz[k])])
                        continue
                    dk = rk.duplicated[start:start + cnt]
                    b = np.flatnonzero(dk[1:] != dk[:-1]) + 1
                    if not len(b):
                        s_cnts.append([cnt])
                        s_dup.append([bool(dk[0])])
                        s_csz.append([int(t_csz[k])])
                    else:
                        ends = np.concatenate([b, [cnt]])
                        begins = np.concatenate([[0], b])
                        s_cnts.append(ends - begins)
                        s_dup.append(dk[begins])
                        s_csz.append(np.full(len(b) + 1, int(t_csz[k]),
                                             dtype=np.int64))
                u_cnts = np.concatenate(s_cnts).astype(np.int64)
                u_csz = np.concatenate(s_csz).astype(np.int64)
                run_dup = np.concatenate(s_dup).astype(bool)
                cnt_cum = np.concatenate([[0], np.cumsum(u_cnts)])
                byte_ends = np.cumsum(u_cnts * u_csz)
                byte_cum = byte_ends - u_cnts * u_csz
                need_pos = np.maximum(need, 0)
                k1 = np.searchsorted(byte_ends, need_pos, side="left")
                m = cnt_cum[k1] - (-(need_pos - byte_cum[k1])
                                   // u_csz[k1])              # ceil divide
                plan["m"] = np.where(need > 0, m, 0)
                plan["v_run"] = (u_cnts, u_csz, run_dup, cnt_cum)
            return plan
        # exact replay of the seed's pop interleaving at run granularity
        # (residency.merge_pop_runs): equal-size run pairs consume each
        # other 1-for-1 in closed form, odd-sized tail chunks step
        # chunk-at-a-time, and only the consumed prefixes are expanded.
        free = self.device_capacity - self.device_used
        s0 = int(ids[0])
        sizes = (r.sizes[s0:s0 + n_own]
                 if int(ids[-1]) - s0 == n_own - 1 else r.sizes[ids])
        _, own_cnts, own_csz = chunk_runs(ids, sizes)
        res = merge_pop_runs(
            (own_csz, own_cnts),
            (q_csz[:n_un_runs], q_cnts[:n_un_runs]),
            (q_csz[n_un_runs:], q_cnts[n_un_runs:]),
            free, region_pinned)
        if res is None:
            return None     # both queues drained: the seed raises
        segments, m_segs, n_un_taken, n_pin_taken, n_own_taken = res
        un_exp = self._expand_victims(
            q_regs[:n_un_runs], q_starts[:n_un_runs], q_cnts[:n_un_runs],
            q_csz[:n_un_runs], upto=n_un_taken) if n_un_taken else None
        pin_exp = self._expand_victims(
            q_regs[n_un_runs:], q_starts[n_un_runs:], q_cnts[n_un_runs:],
            q_csz[n_un_runs:], upto=n_pin_taken) if n_pin_taken else None
        exp = {"un": un_exp, "pin": pin_exp}
        own_idx = np.arange(n_own_taken, dtype=np.int64)
        empty = (np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64),
                 np.zeros(0, dtype=np.int64), np.zeros(0, dtype=bool))
        u = un_exp if un_exp is not None else empty
        p = pin_exp if pin_exp is not None else empty
        plan = {
            "rlist": self._rlist,
            "old": tuple(np.concatenate([a, b]) for a, b in zip(u, p)),
            "own_evicted": own_idx,
        }
        if want_m:
            v_sizes, v_dup = [], []
            for src, off, cnt in segments:
                if src == "own":
                    v_sizes.append(sizes[off:off + cnt])
                    v_dup.append(np.broadcast_to(
                        np.asarray(own_dup, dtype=bool),
                        (n_own,))[off:off + cnt])
                else:
                    _, _, e_sizes, e_dups = exp[src]
                    v_sizes.append(e_sizes[off:off + cnt])
                    v_dup.append(e_dups[off:off + cnt])
            plan["m"] = expand_m_segs(m_segs, n_own)
            plan["v_dup"] = (np.concatenate(v_dup) if v_dup
                             else np.zeros(0, dtype=bool))
            plan["v_sizes"] = (np.concatenate(v_sizes) if v_sizes
                               else np.zeros(0, dtype=np.int64))
        return plan

    def _commit_evictions(self, r: Region, plan) -> None:
        """Apply a victim plan: old residents across regions, then the
        batch's own evicted members (all effects are additive)."""
        if "old_runs" in plan:
            self._apply_eviction_runs(plan["rlist"], *plan["old_runs"])
        else:
            o_regs, o_idxs, o_sizes, o_dups = plan["old"]
            self._apply_evictions(plan["rlist"], o_regs, o_idxs, o_sizes,
                                  o_dups)
        own = plan["own_evicted"]
        if len(own):
            # own_evicted is always the prefix arange(n_own_taken) (the
            # seed pops a batch's own chunks in insertion order): slice
            # views instead of fancy gathers
            cnt = len(own)
            eids = np.asarray(plan["own_ids"])[:cnt]
            edup = np.asarray(plan["own_dup"])[:cnt]
            self._apply_evictions([r], np.zeros(len(eids), dtype=np.int64),
                                  eids, r.sizes[eids], edup)
        self._pressure = True

    def _fault_batch(self, r: Region, ids: np.ndarray, *, duplicate: bool) -> None:
        """Device-side faults for a run of non-resident chunks: batched
        eviction, fault-group, and transfer accounting (seed-equivalent)."""
        s0 = int(ids[0])
        n = len(ids)
        contig = int(ids[-1]) - s0 == n - 1
        sl = slice(s0, s0 + n) if contig else ids
        csz = int(r.sizes[s0])
        s_last = int(r.sizes[int(ids[-1])])
        # regions are built uniform-size with at most an odd final chunk, so
        # a contiguous run's interior is uniform whenever its second-to-last
        # element matches — byte totals and the pressure boundary collapse
        # to scalars with no cumsum over the megachunk page arrays
        uniform = contig and (n < 2 or int(r.sizes[s0 + n - 2]) == csz)
        if uniform:
            ins_cum = None
            total = (n - 1) * csz + s_last
        else:
            sizes = r.sizes[sl]
            ins_cum = np.cumsum(sizes)
            total = int(ins_cum[-1])
        free0 = self.device_capacity - self.device_used
        need_total = total - free0
        pressure0 = self._pressure
        pressure_from = n                # batch index where pressure begins
        virgin = ~r.populated[sl]
        pm = ~virgin
        own_dup = pm if duplicate else np.broadcast_to(np.bool_(False), (n,))
        plan = None
        if need_total > 0:
            need = (np.array([need_total], dtype=np.int64) if uniform
                    else ins_cum - free0)
            plan = self._plan_victims(r, ids, need, own_dup, want_m=False)
            if plan is None:
                for i in ids:            # exact scalar fallback
                    self._fault_one(r, int(i), duplicate=duplicate)
                return
            # the chunk whose insertion first exceeded capacity (and every
            # later one) faults in the pressure regime
            pressure_from = (min(n - 1, free0 // csz) if uniform
                             else int(np.searchsorted(ins_cum, free0,
                                                      side="right")))
        lat = self.p.fault_latency_us * 1e-6
        nv = int(virgin.sum())
        if nv:
            # first device touch of virgin pages: populate on the device —
            # fault latency only, nothing to copy
            events = self._n_fault_events(r, ids[virgin])
            if self._inj is not None:
                events = self._inj.fault_events(events)
            self.t_device += events * lat
            self.report.fault_stall_s += events * lat
            self.report.n_faults += events
        n_pm = int(pm.sum())
        if n_pm:
            # uniform batches: only the final chunk can be odd-sized, so the
            # per-chunk byte/page-group sums are scalar arithmetic off the
            # pm counts — no index expansion or size gathers
            last_pm = bool(pm[n - 1])
            if uniform:
                pm_bytes = n_pm * csz + ((s_last - csz) if last_pm else 0)
            else:
                psz = sizes[pm]
                pm_bytes = int(psz.sum())
            if duplicate and self.p.host_can_access_device:   # coherent fabric
                if pressure0:
                    n_pressured = n_pm
                elif pressure_from < n:
                    n_pressured = int(pm[pressure_from:].sum())
                else:
                    n_pressured = 0
                if n_pressured:
                    # block heuristic disabled: re-duplication faults at
                    # system page granularity — the Fig. 7c/8c explosion
                    if uniform:
                        g = max(1, csz // self.p.page_bytes)
                        n_p = n_pressured * g
                        if last_pm and s_last != csz:
                            n_p += max(1, s_last // self.p.page_bytes) - g
                    else:
                        pressured = (pressure0
                                     | (np.nonzero(pm)[0] >= pressure_from))
                        pgroups = np.maximum(
                            1, psz[pressured] // self.p.page_bytes)
                        n_p = int(pgroups.sum())
                    if self._inj is not None:
                        n_p = self._inj.fault_events(n_p)
                    self.report.fault_stall_s += n_p * lat
                    self.t_device += n_p * lat
                    self.report.n_faults += n_p
                if n_pressured < n_pm:
                    pf = pressure_from if not pressure0 else 0
                    up_ids = ids[:pf][pm[:pf]]
                    events = self._n_fault_events(r, up_ids)
                    if self._inj is not None:
                        events = self._inj.fault_events(events)
                    stall = events * lat * 0.5                # no host unmap
                    self.report.fault_stall_s += stall
                    self.t_device += stall
                    self.report.n_faults += events
            else:
                events = self._n_fault_events(r, ids[pm])
                if self._inj is not None:
                    events = self._inj.fault_events(events)
                self.report.fault_stall_s += events * lat
                self.t_device += events * lat
                self.report.n_faults += events
            xfer = pm_bytes / (self.p.link_bw_gbs * GB
                               * self.p.fault_migration_efficiency)
            if self._inj is not None:
                scale, backoff = self._inj.transfer(xfer)
                xfer *= scale
                self.t_device += backoff
            self.t_device += xfer
            self.report.htod_s += xfer
            self.report.htod_bytes += pm_bytes
        r.populated[sl] = True
        # scalar False keeps the slice-write path; the mixed virgin/dup case
        # needs the per-chunk array
        self._insert_resident(r, ids,
                              duplicate=(own_dup if duplicate else False))
        if plan is not None:
            plan["own_ids"] = ids
            plan["own_dup"] = own_dup
            self._commit_evictions(r, plan)

    def _bulk_copy_one(self, r: Region, idx: int, *, duplicate: bool,
                       asynchronous: bool) -> None:
        """Scalar bulk-copy path — seed `_bulk_copy_chunk` verbatim."""
        size = int(r.sizes[idx])
        if self.device_used + size > self.device_capacity:
            self._evict_for(size)
        xfer = size / (self.p.link_bw_gbs * GB)
        backoff = 0.0
        if self._inj is not None:
            scale, backoff = self._inj.transfer(xfer)
            xfer *= scale
        if asynchronous:
            self.t_copy = max(self.t_copy, self.t_device) + backoff + xfer
            r.arrival[idx] = self.t_copy
        else:
            self.t_device += backoff + xfer
            r.arrival[idx] = self.t_device
        self.report.htod_s += xfer
        self.report.htod_bytes += size
        r.populated[idx] = True
        self._insert_resident(r, np.array([idx]), duplicate=duplicate)

    def _bulk_copy_batch(self, r: Region, ids: np.ndarray, *, duplicate: bool,
                         asynchronous: bool) -> None:
        """Bulk copy a run of non-resident chunks at full link bandwidth,
        reproducing the seed's per-chunk evict -> copy interleaving in closed
        form (victim consumption via searchsorted; copy-stream clock via a
        running-max recurrence)."""
        s0 = int(ids[0])
        n = len(ids)
        sl = slice(s0, s0 + n)           # _copy_walk always passes a run
        csz = int(r.sizes[s0])
        s_last = int(r.sizes[s0 + n - 1])
        uniform = n < 2 or int(r.sizes[s0 + n - 2]) == csz
        free0 = self.device_capacity - self.device_used
        if uniform:
            total = (n - 1) * csz + s_last
        else:
            sizes = r.sizes[sl]
            ins_cum = np.cumsum(sizes)
            total = int(ins_cum[-1])
        if total - free0 <= 0:
            # fast path: everything fits
            if uniform:
                # uniform run: the transfer cumsum is a cached-ramp multiply
                # (one pass, no per-chunk divide), odd tail patched scalar
                self._ramps(n)
                X = self._ramp_f1[:n] * (csz / (self.p.link_bw_gbs * GB))
                if s_last != csz:
                    X[n - 1] = X[n - 2] + s_last / (self.p.link_bw_gbs * GB)
            else:
                X = np.cumsum(sizes / (self.p.link_bw_gbs * GB))
            backoff = 0.0
            if self._inj is not None:
                # one event per bulk-copy run: degradation scales every
                # chunk's arrival, backoff delays the run's start
                scale, backoff = self._inj.transfer(float(X[-1]))
                X *= scale
            xfer_total = float(X[-1])
            if asynchronous:
                X += max(self.t_copy, self.t_device) + backoff
                self.t_copy = float(X[-1])
            else:
                X += self.t_device + backoff
                self.t_device = float(X[-1])
            r.arrival[sl] = X
            self.report.htod_s += xfer_total
            self.report.htod_bytes += total
            r.populated[sl] = True
            self._insert_resident(r, ids, duplicate=duplicate)
            return
        if not asynchronous or not self._bulk_copy_evicting(r, ids, duplicate):
            for i in ids:                # exact scalar fallback
                self._bulk_copy_one(r, int(i), duplicate=duplicate,
                                    asynchronous=asynchronous)

    def _bulk_copy_evicting_uniform(self, r: Region, ids: np.ndarray,
                                    duplicate: bool, csz: int) -> bool | None:
        """Scalar pricing for a size-uniform evicting bulk copy — every run
        at page granularity (only a region's final chunk may be odd-sized,
        and a run is region-contiguous, so at most the *last* insert
        differs).  When the uniform body's chunks and all victims share one
        size ``csz``, each insert adds exactly the bytes one eviction frees,
        so victim consumption steps by one per insert once free space is
        exhausted: the seed's running-max recurrence
        ``t_copy_i = max(t_copy_{i-1}, d_i) + x_i`` has non-increasing
        ``d_i - X_{i-1}`` and collapses to the scalar ``u = max(t_copy_0,
        d_0)`` — no per-chunk victim expansion, cumsum, or searchsorted at
        all.  Odd-size *victims* (a prefix crossing other regions' tails)
        still collapse when every victim is duplicated (write-backs all
        free: d_i == t_device) or the copy stream already leads the device
        clock by the whole write-back budget (the running max is t_copy_0
        itself).  A trailing odd-size insert is priced by one extra scalar
        recurrence step off the total write-back ``W``.  Returns True
        (handled), False (no plan: scalar fallback), or None (own-batch
        eviction, or victim layouts only the per-insert path prices)."""
        s0 = int(ids[0])
        n = len(ids)
        s_last = int(r.sizes[s0 + n - 1])
        tail_odd = s_last != csz
        if tail_odd and n < 2:
            return None              # a lone odd chunk: nothing to collapse
        free0 = self.device_capacity - self.device_used
        total_bytes = (n - 1) * csz + s_last
        own_dup = np.broadcast_to(np.bool_(duplicate), (n,))
        plan = self._plan_victims(
            r, ids, np.array([total_bytes - free0], dtype=np.int64), own_dup,
            want_m=False)
        if plan is None:
            return False
        if "old_runs" not in plan:
            return None              # streaming thrash: own chunks evicted
        t_regs, t_starts, t_cnts, t_csz = plan["old_runs"]
        bw = self.p.link_bw_gbs * GB
        x = csz / bw
        x_last = s_last / bw
        t_copy0 = self.t_copy
        if self._inj is not None:
            scale, backoff = self._inj.transfer((n - 1) * x + x_last)
            x = x * scale
            x_last = x_last * scale
            t_copy0 = t_copy0 + backoff
        q = free0 // csz             # inserts absorbed by free space
        arr = None
        if not bool((t_csz != csz).any()):
            # size-uniform victims: d_i steps by 0 or x per insert, so
            # d_i - X_{i-1} is non-increasing and u = max(t_copy0, d_0)
            if q >= 1:
                d0 = self.t_device   # first insert evicts nothing
            else:
                # first insert consumes exactly one victim; its write-back
                # is free when that chunk is duplicated (a clean drop)
                rv0 = self._rlist[int(t_regs[0])]
                first_dup = rv0.dup_ever and bool(
                    rv0.duplicated[int(t_starts[0])])
                d0 = self.t_device + (0.0 if first_dup else x)
            u = t_copy0 if t_copy0 > d0 else d0
            W = 0.0
            if tail_odd:
                # the last insert needs < csz bytes, so it consumes at most
                # one more victim: m_{n-1} is the whole plan and
                # d_{n-1} = t_device + W, the victims' total *clean*
                # write-back (matching the general path's d_i — write-backs
                # draw their own injector events at commit time)
                mig = sum(
                    int(t_cnts[k])
                    - (int(self._rlist[int(t_regs[k])]
                           .duplicated[int(t_starts[k]):
                                       int(t_starts[k])
                                       + int(t_cnts[k])].sum())
                       if self._rlist[int(t_regs[k])].dup_ever else 0)
                    for k in range(len(t_regs)))
                W = mig * x
        else:
            # odd-size victims in the prefix: split every run into
            # dup-uniform subruns and price per SEGMENT.  Subrun k absorbs
            # the body inserts j in [j_k, j_{k+1}) with
            # j_k = (bytes-before-k + free0) // csz; within a segment
            # g_j = d_j - X_{j-1} is constant (migrated, size csz: each
            # insert consumes exactly one victim), decreasing (duplicated:
            # d flat, X grows), or a single insert (odd-size subruns are
            # lone region tails, < csz bytes), so the running max only
            # moves at segment starts — O(subruns) scalars plus one repeat.
            sub_cnts, sub_csz, sub_dup = [], [], []
            for k in range(len(t_regs)):
                start, cnt = int(t_starts[k]), int(t_cnts[k])
                zk = int(t_csz[k])
                rk = self._rlist[int(t_regs[k])]
                if not rk.dup_ever:
                    sub_cnts.append([cnt])
                    sub_dup.append([False])
                    sub_csz.append([zk])
                    continue
                dk = rk.duplicated[start:start + cnt]
                b = np.flatnonzero(dk[1:] != dk[:-1]) + 1
                if len(b):
                    begins = np.concatenate([[0], b])
                    sub_cnts.append(np.diff(np.concatenate([begins, [cnt]])))
                    sub_dup.append(dk[begins])
                    sub_csz.append(np.full(len(begins), zk, dtype=np.int64))
                else:
                    sub_cnts.append([cnt])
                    sub_dup.append([bool(dk[0])])
                    sub_csz.append([zk])
            c = np.concatenate(sub_cnts).astype(np.int64)
            z = np.concatenate(sub_csz).astype(np.int64)
            f = np.concatenate(sub_dup).astype(bool)
            if bool((z > csz).any()) or bool(((z != csz) & (c > 1)).any()):
                return None      # foreign layout: per-insert pricing
            vd = np.where(f, 0.0, z / bw)
            B = np.concatenate([[0], np.cumsum(c * z)])
            Wc = np.concatenate([[0.0], np.cumsum(c * vd)])
            n_body = n - 1 if tail_odd else n
            j = np.clip((B + free0) // csz, 0, n_body)
            K = len(c)
            # d at each subrun's first insert: that insert still needs
            # (j_k + 1) * csz - free0 - B_k bytes out of subrun k
            a = (j[:K] + 1) * csz - free0 - B[:K]
            d0 = self.t_device + Wc[:K] + (-(-a // z)) * vd
            lens = np.diff(np.concatenate([[0], j]))
            g = np.concatenate([[self.t_device], d0 - j[:K] * x])
            g = np.where(np.concatenate([[True], lens[1:] > 0]), g, -np.inf)
            u_segs = np.maximum(np.maximum.accumulate(g), t_copy0)
            arr = r.arrival[s0:s0 + n]     # computed in place (overwritten
            self._ramps(n_body)            # wholesale below)
            np.multiply(self._ramp_f1[:n_body], x, out=arr[:n_body])
            arr[:n_body] += np.repeat(u_segs, lens)
            W = float(Wc[-1])    # the whole plan's clean write-back
        if arr is None:
            arr = r.arrival[s0:s0 + n]
            nb = n if not tail_odd else n - 1
            self._ramps(nb)
            np.multiply(self._ramp_f1[:nb], x, out=arr[:nb])
            arr[:nb] += u
        if tail_odd:
            prev = float(arr[n - 2])
            d_last = self.t_device + W
            arr[n - 1] = (prev if prev > d_last else d_last) + x_last
        self.t_copy = float(arr[-1])
        self._insert_resident(r, ids, duplicate=duplicate)
        r.populated[s0:s0 + n] = True
        self.report.htod_s += (n - 1) * x + x_last
        self.report.htod_bytes += total_bytes
        plan["own_ids"] = ids
        plan["own_dup"] = own_dup
        self._commit_evictions(r, plan)
        return True

    def _bulk_copy_evicting(self, r: Region, ids: np.ndarray,
                            duplicate: bool) -> bool:
        """Async bulk copy under memory pressure (oversubscribed prefetch and
        the coherent-fabric eager-restore ping-pong).  Victim consumption per
        copied chunk and the copy-stream clock follow in closed form from the
        static victim layout (_plan_victims); returns False when that layout
        cannot be proven equivalent to the seed's interleaved pops."""
        s0 = int(ids[0])
        sl = slice(s0, s0 + len(ids))    # always a run (see _bulk_copy_batch)
        csz = int(r.sizes[s0])
        if len(ids) < 2 or int(r.sizes[s0 + len(ids) - 2]) == csz:
            # the body (all but the last chunk) is size-uniform — always
            # true at page granularity, where only a region's final chunk
            # can be odd; planning is pure, so a None return falls through
            # to the general path at no extra cost
            done = self._bulk_copy_evicting_uniform(r, ids, duplicate, csz)
            if done is not None:
                return done
        n = len(ids)
        bw = self.p.link_bw_gbs * GB
        s_last = int(r.sizes[s0 + n - 1])
        uniform_own = n < 2 or int(r.sizes[s0 + n - 2]) == csz
        if uniform_own:
            # uniform body (odd tail at most): the byte deficit before each
            # insert is an integer arange ramp and the transfer schedule a
            # float one — no size gather, divide, or cumsum over the run
            total = (n - 1) * csz + s_last
            self._ramps(n)
            need = self._ramp_i1[:n] * csz
            if s_last != csz:
                need[n - 1] = total
            need -= self.device_capacity - self.device_used
            x_s, x_last = csz / bw, s_last / bw
            xfer_sum = (n - 1) * x_s + x_last
        else:
            sizes = r.sizes[sl]
            x = sizes / bw
            ins_cum = np.cumsum(sizes)
            total = int(ins_cum[-1])
            need = ins_cum - (self.device_capacity - self.device_used)
            xfer_sum = float(np.sum(x))
        own_dup = np.broadcast_to(np.bool_(duplicate), (n,))
        plan = self._plan_victims(r, ids, need, own_dup)
        if plan is None:
            return False
        t_copy0 = self.t_copy
        if self._inj is not None:
            # one event per evicting bulk-copy run; the victims' write-backs
            # draw their own events inside _commit_evictions, so the d_i
            # below use clean write-back estimates — a schedule-quality
            # approximation (arrivals may be optimistic), never an
            # accounting inconsistency (DESIGN.md §12)
            scale, backoff = self._inj.transfer(xfer_sum)
            if uniform_own:
                x_s, x_last = x_s * scale, x_last * scale
            else:
                x = x * scale
            t_copy0 = t_copy0 + backoff
        # copy-stream clock: the device clock advances by each migrated
        # victim's write-back before the copy that consumed it, so
        # t_copy_i = max(t_copy_{i-1}, d_i) + x_i with d_i closed-form below;
        # the recurrence solves as a running max shifted by the transfer
        # cumsum
        if "v_run" in plan:
            # dup-uniform victim subruns: the write-back time consumed
            # before insert i is piecewise linear in m[i] across subruns — a
            # run-level cumsum plus one searchsorted replaces per-chunk
            # expansion
            t_cnts, t_csz, run_dup, cnt_cum = plan["v_run"]
            vd_run = np.where(run_dup, 0.0, t_csz / bw)
            wb_cum = np.concatenate([[0.0], np.cumsum(t_cnts * vd_run)])
            m = plan["m"]
            k2 = np.searchsorted(cnt_cum[1:], m, side="left")
            d = self.t_device + wb_cum[k2] + (m - cnt_cum[k2]) * vd_run[k2]
        else:
            v_dtoh = np.where(plan["v_dup"], 0.0,
                              plan["v_sizes"] / bw)
            dtoh_cum = np.concatenate([[0.0], np.cumsum(v_dtoh)])
            d = self.t_device + dtoh_cum[plan["m"]]
        if uniform_own:
            X = self._ramp_f1[:n] * x_s
            if s_last != csz:
                X[n - 1] = X[n - 2] + x_last
            # X[i] - x[i] == i * x_s for the whole run (the odd tail's
            # X[n-1] - x_last is X[n-2] == (n-1) * x_s by the ramp)
            d -= self._ramp_f0[:n] * x_s
            u = np.maximum(t_copy0, np.maximum.accumulate(d))
        else:
            X = np.cumsum(x)
            u = np.maximum(t_copy0, np.maximum.accumulate(d - (X - x)))
        arr = u + X
        self.t_copy = float(arr[-1])
        self._insert_resident(r, ids, duplicate=duplicate)
        r.arrival[sl] = arr
        r.populated[sl] = True
        self.report.htod_s += float(X[-1])
        self.report.htod_bytes += total
        plan["own_ids"] = ids
        plan["own_dup"] = own_dup
        self._commit_evictions(r, plan)
        return True

    def _count_and_promote(self, r: Region, ids: np.ndarray, *,
                           duplicate: bool) -> int:
        """Access-counter bookkeeping for one remote-touched run of
        non-resident chunks (DESIGN.md §10): increment and split hot/cold
        (``residency.counter_promote_split``), promote the hot chunks in one
        batched call through the normal fault-migration path — eviction
        planning, fault-group coalescing and transfer accounting all reused
        — and return the bytes the cold remainder accesses remotely."""
        hot, cold = counter_promote_split(ids, r.touch_count,
                                          r.counter_threshold)
        if len(hot):
            self.report.n_promotions += len(hot)
            self.report.promoted_bytes += int(r.sizes[hot].sum())
            self._fault_batch(r, hot, duplicate=duplicate)
        return int(r.sizes[cold].sum())

    # -- public API mirroring the CUDA calls -------------------------------------
    def _copy_walk(self, r: Region, candidates, *, duplicate: bool,
                   asynchronous: bool) -> None:
        """Walk chunk indices in order, bulk-copying each maximal candidate
        run.  Candidates are re-evaluated per run because a copy's evictions
        can change later chunks' state (the seed re-checks lazily per chunk).
        ``candidates(r, pos)`` returns the mask for indices ``pos`` onward
        only, so each re-evaluation pays for the remaining tail instead of
        rebuilding (and index-scanning) the full region mask per run."""
        pos = 0
        while pos < r.nchunks:
            m = candidates(r, pos)
            if not len(m) or not m.any():
                return
            off = int(m.argmax())            # first candidate
            start = pos + off
            inv = ~m[off:]
            ln = int(inv.argmax()) if inv.any() else len(inv)
            self._bulk_copy_batch(r, np.arange(start, start + ln),
                                  duplicate=duplicate, asynchronous=asynchronous)
            pos = start + ln

    def explicit_copy_to_device(self, name: str) -> None:
        """cudaMemcpy HtoD — the 'original' variant. No oversubscription."""
        r = self.regions[name]
        total = self.device_used + int(r.sizes[~r.resident_mask()].sum())
        if total > self.device_capacity:
            raise OversubscriptionError(
                f"explicit allocation of {r.name} exceeds device memory"
            )
        self._copy_walk(r, lambda rr, p: ~(rr.on_device[p:]
                                           | rr.duplicated[p:]),
                        duplicate=False, asynchronous=False)
        self._audited("explicit_copy_to_device", name)

    def explicit_alloc(self, name: str) -> None:
        """cudaMalloc semantics: device allocation, no transfer.  Fails when
        out of memory — explicit variants cannot oversubscribe (paper §IV-B)."""
        r = self.regions[name]
        cand = np.nonzero(~r.resident_mask())[0]
        need = int(r.sizes[cand].sum())
        if self.device_used + need > self.device_capacity:
            raise OversubscriptionError(
                f"explicit allocation of {r.name} exceeds device memory"
            )
        if len(cand):
            self._insert_resident(r, cand, duplicate=False)
        self._audited("explicit_alloc", name)

    def explicit_copy_to_host(self, name: str) -> None:
        r = self.regions[name]
        ids = np.nonzero(r.on_device)[0]
        if len(ids):
            sz = r.sizes[ids]
            t = float((sz / (self.p.link_bw_gbs * GB)).sum())
            if self._inj is not None:
                scale, backoff = self._inj.transfer(t)
                t *= scale
                self.t_device += backoff
            self.t_device += t
            self.report.dtoh_s += t
            self.report.dtoh_bytes += int(sz.sum())
        self._audited("explicit_copy_to_host", name)

    def prefetch(self, name: str, dst: MemorySpace = MemorySpace.DEVICE,
                 nbytes: int | None = None) -> None:
        """cudaMemPrefetchAsync: bulk, background stream, no faults.

        Prefetching a READ_MOSTLY region creates duplicates immediately
        (paper §II-C); prefetching away from a PREFERRED_LOCATION un-pins
        (paper: 'the pages will no longer be pinned').  Prefetching *to the
        host* drops READ_MOSTLY duplicates for free — the host copy is
        still valid, so there is nothing to move (DESIGN.md §2), only
        device memory to release — while moved chunks pay the DtoH copy.

        ``nbytes`` limits the prefetch to the first ``nbytes`` of the
        region (``host_write`` semantics; rounded up to whole chunks) — the
        capacity-aware scheduler (DESIGN.md §11) uses it to cut a prefetch
        window at a chunk boundary instead of staging a whole region.
        """
        r = self.regions[name]
        nch = (r.nchunks if nbytes is None
               else min(r.nchunks, max(1, math.ceil(nbytes / r.chunk_bytes))))
        if dst is MemorySpace.DEVICE:
            def candidates(rr: Region, pos: int) -> np.ndarray:
                if pos >= nch:
                    return np.zeros(0, dtype=bool)
                return ~(rr.on_device[pos:nch] | rr.duplicated[pos:nch])
            h0 = self.report.htod_s
            before = r.resident_mask()
            self._copy_walk(r, candidates,
                            duplicate=r.read_mostly, asynchronous=True)
            # copy-stream busy time attributable to this prefetch (the HtoD
            # added by the walk; eviction write-backs stay in dtoh_s)
            self.report.prefetch_copy_s += self.report.htod_s - h0
            new = r.resident_mask() & ~before
            if new.any():
                if r.pf_mark is None:
                    r.pf_mark = np.zeros(r.nchunks, dtype=bool)
                r.pf_mark[new] = True
        else:
            if r.preferred is MemorySpace.DEVICE:
                r.preferred = None  # un-pin
            dup = np.nonzero(r.duplicated[:nch])[0]
            if len(dup):
                # free drop: no transfer, no clock movement — just release
                # the device copy and un-file it from the residency index
                self.device_used -= int(r.sizes[dup].sum())
                self.report.n_dropped += len(dup)
                self._index_remove(r, dup)
                r.duplicated[dup] = False
                self._pf_clear(r, dup)
            ids = np.nonzero(r.on_device[:nch])[0]
            if len(ids):
                sz = r.sizes[ids]
                t = float((sz / (self.p.link_bw_gbs * GB)).sum())
                backoff = 0.0
                if self._inj is not None:
                    scale, backoff = self._inj.transfer(t)
                    t *= scale
                self.t_copy = max(self.t_copy, self.t_device) + backoff + t
                self.report.dtoh_s += t
                self.report.dtoh_bytes += int(sz.sum())
                self.device_used -= int(sz.sum())
                self._index_remove(r, ids)
                r.on_device[ids] = False
                r.duplicated[ids] = False
                self._pf_clear(r, ids)
        self._audited("prefetch", name)

    def _eager_restore(self) -> None:
        """Coherent-fabric runtime behaviour under memory pressure: pages
        with PREFERRED_LOCATION(DEVICE) that were evicted as a last resort
        are eagerly migrated back once the kernel finishes — restoring the
        preference but evicting other pages in turn.  This ping-pong is the
        'intense data movement in both directions' the paper traces for
        advise + oversubscription on P9 (Fig. 7d/8c).  PCIe drivers stay
        lazy (no remote mapping to maintain), so Intel platforms skip this.
        """
        if not (self.p.host_can_access_device and self._pressure):
            return
        for r in self.regions.values():
            if r.preferred is not MemorySpace.DEVICE:
                continue
            self._copy_walk(
                r, lambda rr, p: (~(rr.on_device[p:] | rr.duplicated[p:])
                                  & rr.populated[p:]),
                duplicate=False, asynchronous=True)

    def host_write(self, name: str, nbytes: int | None = None) -> None:
        """Host writes the region (e.g. initialization).

        - If pages are host-resident: local write, free (host compute not on
          the device timeline, matching the paper's figure of merit = GPU
          kernel time).
        - Writing a READ_MOSTLY region invalidates device duplicates.
        - If pages are device-resident: remote write when the platform maps
          device memory on the host (P9/NVLink) and the region is advised
          ACCESSED_BY(HOST) or pinned to device; otherwise the pages migrate
          back (CPU-side faults).
        """
        r = self.regions[name]
        nbytes = r.nbytes if nbytes is None else nbytes
        nch = max(1, math.ceil(nbytes / r.chunk_bytes))
        nch = min(nch, r.nchunks)
        # the touched ids are the arange prefix [0, nch): every mask gather
        # below reads the region arrays through slices instead of index
        # arrays
        if r.dup_ever:
            dup_ids = np.nonzero(r.duplicated[:nch])[0]
        else:
            dup_ids = np.zeros(0, dtype=np.int64)
        if len(dup_ids):
            r.duplicated[dup_ids] = False  # write invalidates the duplicate
            gone = dup_ids[~r.on_device[dup_ids]]
            self.device_used -= int(r.sizes[gone].sum())
            if len(gone):
                self._index_remove(r, gone)
                self._pf_clear(r, gone)
        dev_ids = np.nonzero(r.on_device[:nch])[0]
        if len(dev_ids):
            sz = r.sizes[dev_ids]
            total = int(sz.sum())
            wants_remote = (
                Accessor.HOST in r.accessed_by
                or r.preferred is MemorySpace.DEVICE
            )
            if wants_remote and self.p.host_can_access_device:
                t = float((sz / (self.p.link_bw_gbs * GB
                                 * self.p.remote_access_efficiency)).sum())
                self.report.remote_s += t
                self.report.remote_bytes += total
                # remote access happens on the host timeline; it delays
                # subsequent kernels only through t_copy ordering
                self.t_copy = max(self.t_copy, self.t_device) + t
            else:
                events = self._n_fault_events(r, dev_ids)
                stall = events * self.p.fault_latency_us * 1e-6
                xfer = float((sz / (self.p.link_bw_gbs * GB)).sum())
                backoff = 0.0
                if self._inj is not None:
                    scale, backoff = self._inj.transfer(xfer)
                    xfer *= scale
                self.report.fault_stall_s += stall
                self.report.dtoh_s += xfer
                self.report.dtoh_bytes += total
                self.report.n_faults += events
                self.t_copy = (max(self.t_copy, self.t_device)
                               + stall + backoff + xfer)
                self.device_used -= total
                self._index_remove(r, dev_ids)
                r.on_device[dev_ids] = False
                self._pf_clear(r, dev_ids)
        r.populated[:nch] = True
        self._audited("host_write", name)

    def host_read(self, name: str, nbytes: int | None = None) -> None:
        """Host reads results. Device-resident pages migrate back unless the
        host can access them remotely (ACCESSED_BY HOST on P9)."""
        r = self.regions[name]
        nbytes = r.nbytes if nbytes is None else nbytes
        nch = max(1, math.ceil(nbytes / r.chunk_bytes))
        nch = min(nch, r.nchunks)
        sel = (np.nonzero(r.on_device[:nch] & ~r.duplicated[:nch])[0]
               if r.dup_ever else np.nonzero(r.on_device[:nch])[0])
        if not len(sel):
            self._audited("host_read", name)
            return
        sz = r.sizes[sel]
        total = int(sz.sum())
        if Accessor.HOST in r.accessed_by and self.p.host_can_access_device:
            t = float((sz / (self.p.link_bw_gbs * GB
                             * self.p.remote_access_efficiency)).sum())
            self.report.remote_s += t
            self.report.remote_bytes += total
            self.t_copy = max(self.t_copy, self.t_device) + t
        else:
            events = self._n_fault_events(r, sel)
            stall = events * self.p.fault_latency_us * 1e-6
            xfer = float((sz / (self.p.link_bw_gbs * GB)).sum())
            backoff = 0.0
            if self._inj is not None:
                scale, backoff = self._inj.transfer(xfer)
                xfer *= scale
            self.report.fault_stall_s += stall
            self.report.dtoh_s += xfer
            self.report.dtoh_bytes += total
            self.report.n_faults += events
            self.t_device += stall + backoff + xfer
            self.device_used -= total
            self._index_remove(r, sel)
            r.on_device[sel] = False
            self._pf_clear(r, sel)
        self._audited("host_read", name)

    def kernel(
        self,
        name: str,
        *,
        flops: float,
        reads: list[str],
        writes: list[str],
        bytes_touched: float | None = None,
        partial: Mapping[str, float] | None = None,
    ) -> None:
        """Launch a GPU kernel.  Non-resident chunks of accessed regions fault
        (or are read remotely for host-pinned ACCESSED_BY(DEVICE) regions).
        Writes to READ_MOSTLY duplicates invalidate them first.

        ``partial`` maps region name -> fraction in (0,1]: only that fraction
        of the region's chunks is touched, starting at a rotating per-region
        cursor (models data-dependent access like a BFS frontier sweep).
        """
        partial = partial or {}
        read_set = [self.regions[n] for n in reads]
        write_set = [self.regions[n] for n in writes]
        remote_bytes = 0

        def chunk_ids(r: Region) -> np.ndarray:
            frac = partial.get(r.name)
            if frac is None:
                if r.all_ids is None:
                    r.all_ids = np.arange(r.nchunks)
                return r.all_ids
            n = max(1, int(frac * r.nchunks))
            ids = (r.cursor + np.arange(n)) % r.nchunks
            r.cursor = (r.cursor + n) % r.nchunks
            return ids

        touched: dict[str, np.ndarray] = {}
        for r in read_set + write_set:
            if r.name not in touched:
                touched[r.name] = chunk_ids(r)

        lat = self.p.fault_latency_us * 1e-6
        for r in write_set:
            if not r.dup_ever:
                continue
            ids = touched[r.name]
            d = ids[r.duplicated[ids]]
            if len(d):
                # a device write invalidates the host copy: promote the
                # duplicate to an exclusive device page (small latency)
                r.duplicated[d] = False
                r.on_device[d] = True
                self.report.fault_stall_s += len(d) * lat
                self.t_device += len(d) * lat

        for r in read_set + write_set:
            pinned_host = r.preferred is MemorySpace.HOST
            dup_flag = r.read_mostly and r in read_set and r not in write_set
            ids = touched[r.name]
            contig = partial.get(r.name) is None   # ids is arange(nchunks)
            pos, n = 0, len(ids)
            while pos < n:
                if contig:
                    # dup_ever False guarantees duplicated is all-False:
                    # read on_device as a view, no or-temp per segment
                    res = (r.on_device[pos:] | r.duplicated[pos:]
                           if r.dup_ever else r.on_device[pos:])
                else:
                    rem = ids[pos:]
                    res = (r.on_device[rem] | r.duplicated[rem]
                           if r.dup_ever else r.on_device[rem])
                brk = np.nonzero(res != res[0])[0]
                ln = int(brk[0]) if len(brk) else len(res)
                seg = ids[pos:pos + ln]
                if res[0]:
                    # may still be in flight from an async prefetch
                    arr_seg = (r.arrival[pos:pos + ln] if contig
                               else r.arrival[seg])
                    am = int(np.argmax(arr_seg))
                    mx = float(arr_seg[am])
                    if mx > self.t_device:
                        # exposed (un-hidden) copy time: the kernel reached
                        # data the copy stream has not delivered yet.  Only
                        # counted when a *prefetch-issued* copy is what the
                        # kernel waits on — eager-restore traffic also sets
                        # arrivals but is not prefetch (§11 accounting)
                        if r.pf_mark is not None and r.pf_mark[seg[am]]:
                            self.report.prefetch_wait_s += mx - self.t_device
                        self.t_device = mx
                    self._touch(r, seg)
                elif pinned_host and self.p.device_can_access_host:
                    if r.counter_threshold is None:
                        remote_bytes += int(r.sizes[seg].sum())  # mapped, no migration
                    else:
                        remote_bytes += self._count_and_promote(
                            r, seg, duplicate=dup_flag)
                else:
                    self._fault_batch(r, seg, duplicate=dup_flag)
                pos += ln

        local_bytes = bytes_touched
        if local_bytes is None:
            local_bytes = float(
                sum(r.bytes_total if len(touched[r.name]) == r.nchunks
                    else int(r.sizes[touched[r.name]].sum())
                    for r in read_set + write_set)
            )
        compute = max(
            flops / (self.p.device_flops_tps * 1e12),
            (local_bytes - remote_bytes) / (self.p.device_bw_gbs * GB),
        )
        remote_t = remote_bytes / (
            self.p.link_bw_gbs * GB * self.p.remote_access_efficiency
        )
        self.t_device += compute + remote_t
        self.report.compute_s += compute
        self.report.remote_s += remote_t
        self.report.remote_bytes += remote_bytes
        for r in write_set:
            t = touched[r.name]
            if len(t) == r.nchunks:     # full/wrapped-full touch covers all
                r.populated[:] = True
            else:
                r.populated[t] = True
        self._eager_restore()
        # rolling thrash window (§12): one sample per launch — the deltas
        # since the previous launch, including eviction/fault activity from
        # prefetches and eager restores in between.  Pure observation.
        self.report.thrash.observe(self.report.n_faults,
                                   self.report.n_evictions)
        self._audited("kernel", name)

    def finish(self) -> SimReport:
        # prefetch copy time the compute stream never saw: busy copy-stream
        # seconds minus the stalls kernels spent waiting on arrivals
        # (staged-vs-pipelined schedules differ exactly here, DESIGN.md §11)
        self.report.prefetch_overlap_s = max(
            0.0, self.report.prefetch_copy_s - self.report.prefetch_wait_s)
        if self._inj is not None:
            # injection accounting lives on the injector during the run;
            # surface the cumulative totals on the report (§12)
            self.report.n_retries = self._inj.n_retries
            self.report.retry_stall_s = self._inj.retry_stall_s
            self.report.n_degraded_xfers = self._inj.n_degraded_xfers
            self.report.n_storm_faults = self._inj.n_storm_faults
        self.report.total_s = max(self.t_device, self.t_copy)
        return self.report
