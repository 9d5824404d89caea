"""Seed (reference) UMSimulator: the original pure-Python per-chunk model.

This is the chunk-by-chunk ``OrderedDict`` implementation the repo seeded
with, the port's copy of ``repro.core.seed_simulator``.  It is kept verbatim
as the *parity oracle* for the vectorized engine in
``repro_torch.core.simulator`` — tests/test_torch_seed_simulator.py asserts
the two produce identical ``SimReport`` counters and (to 1e-9 relative) times on a
sample of matrix cells.  It is O(nchunks) per operation and ~60x slower on
the full matrix; do not use it outside tests.

Model documentation (identical for both engines, see DESIGN.md §2):
a page/chunk-granular model of

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
          * Coherent fabrics (P9/NVLink ATS): duplication skips the host
            unmap/TLB-shootdown, halving fault latency in-memory (advise
            wins), BUT under memory pressure the block heuristic is
            disabled and re-duplication faults at system page granularity
            (64 KB) — the fault explosion the paper traces in Fig. 7c/8c.
      - PREFERRED_LOCATION: pins pages; under memory pressure pinned pages
        are evicted only as a last resort (CUDA treats the advise as a hint).
        If the accessor cannot remote-map the target memory, falls back to
        migration (paper: "the page will be migrated as in the standard UM").
      - ACCESSED_BY: establishes a remote mapping (no fault, no migration)
        when the platform's interconnect supports that direction
        (host->device only on NVLink/P9; device->host also on PCIe).
  * asynchronous bulk prefetch (paper §II-C): full-bandwidth transfer on a
    background copy stream, zero fault latency, overlapped with compute.

Timing model: one device (compute) stream and one copy stream.  Page faults
stall the compute stream (massive parallelism means a faulting kernel makes
no progress — paper §II-A).  The report exposes the same breakdown as the
paper's Fig. 4/7: compute, fault stall, HtoD time, DtoH time.
"""
from __future__ import annotations

import dataclasses
import math
from collections import OrderedDict
from typing import Mapping

from repro_torch.core.advise import Accessor, AdvisePolicy, MemorySpace
from repro_torch.core.simulator import (
    GB,
    KB,
    MB,
    OversubscriptionError,
    SimPlatform,
    SimReport,
)


@dataclasses.dataclass
class Region:
    name: str
    nbytes: int
    role: str = "data"
    # advise state
    read_mostly: bool = False
    preferred: MemorySpace | None = None
    accessed_by: tuple[Accessor, ...] = ()
    # residency state, chunk-granular
    chunk_bytes: int = 2 * MB
    nchunks: int = 0
    # per-chunk: where the authoritative copy lives
    loc: list[MemorySpace] = dataclasses.field(default_factory=list)
    # per-chunk: device holds a read-only duplicate (host copy also valid)
    duplicated: list[bool] = dataclasses.field(default_factory=list)
    # per-chunk arrival time on the copy stream (for in-flight prefetches)
    arrival: list[float] = dataclasses.field(default_factory=list)
    # per-chunk: has real data been written yet (virgin pages move for free)
    populated: list[bool] = dataclasses.field(default_factory=list)
    # rotating cursor for partial (data-dependent) accesses, e.g. BFS levels
    cursor: int = 0

    def __post_init__(self):
        self.nchunks = max(1, math.ceil(self.nbytes / self.chunk_bytes))
        self.loc = [MemorySpace.HOST] * self.nchunks
        self.duplicated = [False] * self.nchunks
        self.arrival = [0.0] * self.nchunks
        self.populated = [False] * self.nchunks

    def chunk_size(self, idx: int) -> int:
        if idx == self.nchunks - 1:
            rem = self.nbytes - idx * self.chunk_bytes
            return rem if rem > 0 else self.chunk_bytes
        return self.chunk_bytes

    def device_resident(self, idx: int) -> bool:
        return self.loc[idx] is MemorySpace.DEVICE or self.duplicated[idx]


class UMSimulator:
    def __init__(self, platform: SimPlatform, policy: AdvisePolicy | None = None):
        self.p = platform
        self.policy = policy or AdvisePolicy()
        self.regions: dict[str, Region] = {}
        self.report = SimReport()
        self.t_device = 0.0          # compute stream clock
        self.t_copy = 0.0            # copy stream clock
        self.device_used = 0         # bytes resident on device
        # FIFO residency order (approximate LRU): (region_name, chunk_idx).
        # Two queues: unpinned (evicted first) and pinned (last resort —
        # PREFERRED_LOCATION(DEVICE) is a hint, not a guarantee).  Membership
        # is reclassified lazily at pop time if advises changed.
        self._res_un: OrderedDict[tuple[str, int], bool] = OrderedDict()
        self._res_pin: OrderedDict[tuple[str, int], bool] = OrderedDict()
        # set once eviction has happened: the memory-pressure regime in which
        # coherent platforms lose the block-duplication heuristic (see header)
        self._pressure = False

    def _is_pinned(self, key: tuple[str, int]) -> bool:
        return self.regions[key[0]].preferred is MemorySpace.DEVICE

    def _resident_contains(self, key) -> bool:
        return key in self._res_un or key in self._res_pin

    def _resident_remove(self, key) -> bool:
        if key in self._res_un:
            self._res_un.pop(key)
            return True
        if key in self._res_pin:
            self._res_pin.pop(key)
            return True
        return False

    def _resident_add(self, key) -> None:
        (self._res_pin if self._is_pinned(key) else self._res_un)[key] = True

    def residency_snapshot(self) -> list[tuple[str, int]]:
        """(region name, chunk) pairs in queue-filed pop order — the literal
        OrderedDict contents, unpinned queue then pinned queue.  Oracle hook
        for the vectorized engine's incremental residency index
        (tests/test_torch_seed_simulator.py compares it after every op)."""
        return list(self._res_un) + list(self._res_pin)

    # -- capacity ------------------------------------------------------------
    @property
    def device_capacity(self) -> int:
        return int(self.p.device_mem_gb * GB)

    # -- allocation & advises --------------------------------------------------
    def alloc(self, name: str, nbytes: int, role: str = "data") -> Region:
        if name in self.regions:
            raise ValueError(f"region {name} exists")
        r = Region(name, int(nbytes), role=role, chunk_bytes=self.p.fault_group_bytes)
        self.regions[name] = r
        self._apply_policy(r)
        return r

    def _apply_policy(self, r: Region) -> None:
        for key in (r.name, r.role):
            if self.policy.is_read_mostly(key):
                r.read_mostly = True
            loc = self.policy.preferred_location(key)
            if loc is not None:
                r.preferred = loc
            r.accessed_by = r.accessed_by + self.policy.accessed_by(key)

    def advise_read_mostly(self, name: str) -> None:
        self.regions[name].read_mostly = True

    def advise_preferred_location(self, name: str, space: MemorySpace) -> None:
        r = self.regions[name]
        r.preferred = space
        # Virgin (never-written) pages are *created* at the preferred
        # location when the host can address it (coherent fabrics): the
        # host then initializes device-resident pages via remote writes —
        # the paper's P9 in-memory win for CG/FDTD (§IV-A).
        if space is MemorySpace.DEVICE and self.p.host_can_access_device:
            for i in range(r.nchunks):
                if not r.populated[i] and not r.device_resident(i):
                    if self.device_used + r.chunk_size(i) > self.device_capacity:
                        break  # placement preference, not a guarantee
                    self._mark_resident(r, i, duplicate=False)

    def advise_accessed_by(self, name: str, accessor: Accessor) -> None:
        r = self.regions[name]
        r.accessed_by = r.accessed_by + (accessor,)

    # -- residency bookkeeping -------------------------------------------------
    def _mark_resident(self, r: Region, idx: int, *, duplicate: bool) -> None:
        key = (r.name, idx)
        if not self._resident_remove(key):
            self.device_used += r.chunk_size(idx)
        self._resident_add(key)
        if duplicate:
            r.duplicated[idx] = True           # host copy stays valid
        else:
            r.loc[idx] = MemorySpace.DEVICE

    def _touch(self, r: Region, idx: int) -> None:
        key = (r.name, idx)
        if key in self._res_un:
            self._res_un.move_to_end(key)
        elif key in self._res_pin:
            self._res_pin.move_to_end(key)

    def _evict_for(self, need: int) -> None:
        """Evict least-recently-resident chunks until `need` bytes fit.

        Non-pinned chunks go first; pinned (preferred-location DEVICE) chunks
        are a last resort, mirroring CUDA treating the advise as a hint.
        Duplicated (read-mostly) chunks are dropped for free; migrated chunks
        pay a DtoH transfer — UM *moves* pages, so the host has no copy.
        """
        self._pressure = True
        while self.device_used + need > self.device_capacity:
            if self._res_un:
                key, _ = self._res_un.popitem(last=False)
                if self._is_pinned(key):      # advise changed since insert
                    self._res_pin[key] = True
                    continue
            elif self._res_pin:
                key, _ = self._res_pin.popitem(last=False)
                if not self._is_pinned(key):  # un-pinned since insert
                    self._res_un[key] = True
                    continue
            else:
                raise OversubscriptionError(f"cannot free {need} bytes")
            r = self.regions[key[0]]
            idx = key[1]
            size = r.chunk_size(idx)
            self.device_used -= size
            self.report.n_evictions += 1
            if r.duplicated[idx]:
                r.duplicated[idx] = False   # free drop (host copy valid)
                self.report.n_dropped += 1
            else:
                # migrate back to host; eviction is on the critical path of
                # the allocation that triggered it.
                t = size / (self.p.link_bw_gbs * GB)
                self.report.dtoh_s += t
                self.report.dtoh_bytes += size
                self.t_device += t
                r.loc[idx] = MemorySpace.HOST

    # -- transfers ---------------------------------------------------------------
    def _fault_migrate(self, r: Region, idx: int, *, duplicate: bool) -> None:
        """Device-side fault: stall compute for fault handling + transfer.

        Platform-dependent duplication cost — see class docstring."""
        size = r.chunk_size(idx)
        if self.device_used + size > self.device_capacity:
            self._evict_for(size)
        if not r.populated[idx]:
            # first touch of a virgin page by the device: populate on the
            # device — fault latency only, nothing to copy
            stall = self.p.fault_latency_us * 1e-6
            self.t_device += stall
            self.report.fault_stall_s += stall
            self.report.n_faults += 1
            r.populated[idx] = True
            self._mark_resident(r, idx, duplicate=False)
            return
        groups = 1
        latency = self.p.fault_latency_us
        if duplicate and self.p.host_can_access_device:       # coherent fabric
            if self._pressure:
                groups = max(1, size // self.p.page_bytes)    # ATS 64K faults
            else:
                latency *= 0.5                                # no host unmap
        stall = groups * latency * 1e-6
        xfer = size / (self.p.link_bw_gbs * GB * self.p.fault_migration_efficiency)
        self.t_device += stall + xfer
        self.report.fault_stall_s += stall
        self.report.htod_s += xfer
        self.report.htod_bytes += size
        self.report.n_faults += groups
        self._mark_resident(r, idx, duplicate=duplicate)

    def _bulk_copy_chunk(self, r: Region, idx: int, *, duplicate: bool, asynchronous: bool) -> None:
        size = r.chunk_size(idx)
        if self.device_used + size > self.device_capacity:
            self._evict_for(size)
        xfer = size / (self.p.link_bw_gbs * GB)
        if asynchronous:
            self.t_copy = max(self.t_copy, self.t_device) + xfer
            r.arrival[idx] = self.t_copy
        else:
            self.t_device += xfer
            r.arrival[idx] = self.t_device
        self.report.htod_s += xfer
        self.report.htod_bytes += size
        r.populated[idx] = True
        self._mark_resident(r, idx, duplicate=duplicate)

    # -- public API mirroring the CUDA calls -------------------------------------
    def explicit_copy_to_device(self, name: str) -> None:
        """cudaMemcpy HtoD — the 'original' variant. No oversubscription."""
        r = self.regions[name]
        total = self.device_used + sum(
            r.chunk_size(i) for i in range(r.nchunks) if not r.device_resident(i)
        )
        if total > self.device_capacity:
            raise OversubscriptionError(
                f"explicit allocation of {r.name} exceeds device memory"
            )
        for i in range(r.nchunks):
            if not r.device_resident(i):
                self._bulk_copy_chunk(r, i, duplicate=False, asynchronous=False)

    def explicit_alloc(self, name: str) -> None:
        """cudaMalloc semantics: device allocation, no transfer.  Fails when
        out of memory — explicit variants cannot oversubscribe (paper §IV-B)."""
        r = self.regions[name]
        need = sum(
            r.chunk_size(i) for i in range(r.nchunks) if not r.device_resident(i)
        )
        if self.device_used + need > self.device_capacity:
            raise OversubscriptionError(
                f"explicit allocation of {r.name} exceeds device memory"
            )
        for i in range(r.nchunks):
            if not r.device_resident(i):
                self._mark_resident(r, i, duplicate=False)

    def explicit_copy_to_host(self, name: str) -> None:
        r = self.regions[name]
        for i in range(r.nchunks):
            if r.loc[i] is MemorySpace.DEVICE:
                t = r.chunk_size(i) / (self.p.link_bw_gbs * GB)
                self.t_device += t
                self.report.dtoh_s += t
                self.report.dtoh_bytes += r.chunk_size(i)

    def prefetch(self, name: str, dst: MemorySpace = MemorySpace.DEVICE,
                 nbytes: int | None = None) -> None:
        """cudaMemPrefetchAsync: bulk, background stream, no faults.

        Prefetching a READ_MOSTLY region creates duplicates immediately
        (paper §II-C); prefetching away from a PREFERRED_LOCATION un-pins
        (paper: 'the pages will no longer be pinned').  Prefetching to the
        host drops READ_MOSTLY duplicates for free (host copy valid,
        DESIGN.md §2).  ``nbytes`` limits the call to the region's first
        chunks (``host_write`` semantics), mirroring the vectorized engine
        so §11 prefetch plans replay on either engine.
        """
        r = self.regions[name]
        nch = (r.nchunks if nbytes is None
               else min(r.nchunks, max(1, math.ceil(nbytes / r.chunk_bytes))))
        if dst is MemorySpace.DEVICE:
            for i in range(nch):
                if not r.device_resident(i):
                    self._bulk_copy_chunk(
                        r, i, duplicate=r.read_mostly, asynchronous=True
                    )
        else:
            if r.preferred is MemorySpace.DEVICE:
                r.preferred = None  # un-pin
            for i in range(nch):
                if r.duplicated[i] and r.loc[i] is not MemorySpace.DEVICE:
                    # READ_MOSTLY duplicate: the host copy is still valid,
                    # so the "prefetch to host" is a free drop — release the
                    # device copy, move nothing (DESIGN.md §2)
                    r.duplicated[i] = False
                    self.report.n_dropped += 1
                    if self._resident_remove((r.name, i)):
                        self.device_used -= r.chunk_size(i)
                elif r.loc[i] is MemorySpace.DEVICE:
                    size = r.chunk_size(i)
                    xfer = size / (self.p.link_bw_gbs * GB)
                    self.t_copy = max(self.t_copy, self.t_device) + xfer
                    self.report.dtoh_s += xfer
                    self.report.dtoh_bytes += size
                    r.loc[i] = MemorySpace.HOST
                    key = (r.name, i)
                    if self._resident_remove(key):
                        self.device_used -= size
                    r.duplicated[i] = False

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
            for i in range(r.nchunks):
                if not r.device_resident(i) and r.populated[i]:
                    self._bulk_copy_chunk(r, i, duplicate=False, asynchronous=True)

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
        for i in range(min(nch, r.nchunks)):
            if r.duplicated[i]:
                r.duplicated[i] = False  # write invalidates the duplicate
                key = (r.name, i)
                if r.loc[i] is not MemorySpace.DEVICE and self._resident_remove(key):
                    self.device_used -= r.chunk_size(i)
            if r.loc[i] is MemorySpace.DEVICE:
                wants_remote = (
                    Accessor.HOST in r.accessed_by
                    or r.preferred is MemorySpace.DEVICE
                )
                if wants_remote and self.p.host_can_access_device:
                    size = r.chunk_size(i)
                    t = size / (
                        self.p.link_bw_gbs * GB * self.p.remote_access_efficiency
                    )
                    self.report.remote_s += t
                    self.report.remote_bytes += size
                    # remote access happens on the host timeline; it delays
                    # subsequent kernels only through t_copy ordering
                    self.t_copy = max(self.t_copy, self.t_device) + t
                else:
                    size = r.chunk_size(i)
                    stall = self.p.fault_latency_us * 1e-6
                    xfer = size / (self.p.link_bw_gbs * GB)
                    self.report.fault_stall_s += stall
                    self.report.dtoh_s += xfer
                    self.report.dtoh_bytes += size
                    self.report.n_faults += 1
                    self.t_copy = max(self.t_copy, self.t_device) + stall + xfer
                    key = (r.name, i)
                    if self._resident_remove(key):
                        self.device_used -= size
                    r.loc[i] = MemorySpace.HOST
            r.populated[i] = True

    def host_read(self, name: str, nbytes: int | None = None) -> None:
        """Host reads results. Device-resident pages migrate back unless the
        host can access them remotely (ACCESSED_BY HOST on P9)."""
        r = self.regions[name]
        nbytes = r.nbytes if nbytes is None else nbytes
        nch = max(1, math.ceil(nbytes / r.chunk_bytes))
        for i in range(min(nch, r.nchunks)):
            if r.loc[i] is MemorySpace.DEVICE and not r.duplicated[i]:
                if Accessor.HOST in r.accessed_by and self.p.host_can_access_device:
                    size = r.chunk_size(i)
                    t = size / (
                        self.p.link_bw_gbs * GB * self.p.remote_access_efficiency
                    )
                    self.report.remote_s += t
                    self.report.remote_bytes += size
                    self.t_copy = max(self.t_copy, self.t_device) + t
                else:
                    size = r.chunk_size(i)
                    stall = self.p.fault_latency_us * 1e-6
                    xfer = size / (self.p.link_bw_gbs * GB)
                    self.report.fault_stall_s += stall
                    self.report.dtoh_s += xfer
                    self.report.dtoh_bytes += size
                    self.report.n_faults += 1
                    self.t_device += stall + xfer
                    key = (r.name, i)
                    if self._resident_remove(key):
                        self.device_used -= size
                    r.loc[i] = MemorySpace.HOST

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

        def chunk_ids(r: Region):
            frac = partial.get(r.name)
            if frac is None:
                return range(r.nchunks)
            n = max(1, int(frac * r.nchunks))
            ids = [(r.cursor + j) % r.nchunks for j in range(n)]
            r.cursor = (r.cursor + n) % r.nchunks
            return ids

        touched: dict[str, list[int]] = {}
        for r in read_set + write_set:
            if r.name not in touched:
                touched[r.name] = list(chunk_ids(r))

        for r in write_set:
            for i in touched[r.name]:
                if r.duplicated[i]:
                    # a device write invalidates the host copy: promote the
                    # duplicate to an exclusive device page (small latency)
                    r.duplicated[i] = False
                    r.loc[i] = MemorySpace.DEVICE
                    self.report.fault_stall_s += self.p.fault_latency_us * 1e-6
                    self.t_device += self.p.fault_latency_us * 1e-6

        for r in read_set + write_set:
            pinned_host = r.preferred is MemorySpace.HOST
            for i in touched[r.name]:
                if r.device_resident(i):
                    # may still be in flight from an async prefetch
                    if r.arrival[i] > self.t_device:
                        wait = r.arrival[i] - self.t_device
                        self.t_device += wait
                    self._touch(r, i)
                    continue
                if pinned_host and self.p.device_can_access_host:
                    remote_bytes += r.chunk_size(i)  # mapped, no migration
                    continue
                self._fault_migrate(r, i, duplicate=r.read_mostly and r in read_set and r not in write_set)

        local_bytes = bytes_touched
        if local_bytes is None:
            local_bytes = float(
                sum(
                    sum(r.chunk_size(i) for i in touched[r.name])
                    for r in read_set + write_set
                )
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
            for i in touched[r.name]:
                r.populated[i] = True
        self._eager_restore()

    def finish(self) -> SimReport:
        self.report.total_s = max(self.t_device, self.t_copy)
        return self.report
