"""ResidencyPlanner — oversubscription management (paper §II-D), planned.

The port's copy of ``repro.core.residency`` (which imports no JAX): the
planner, plus the array-backed residency-order primitives the vectorized UM
simulator (``core/simulator.py``) uses for LRU victim selection (DESIGN.md
§Simulator internals), the incrementally maintained, run-coalesced
residency index (DESIGN.md §9) and the per-chunk access-counter split
(DESIGN.md §10) behind the remote-access-first hybrid tier.  The
primitives are NumPy, as the reference's are: the simulator models a device,
it runs on the host.

CUDA UM reacts to memory pressure with page faults + LRU eviction.  The
planner decides residency *ahead of time* instead: given (arch, shape, mesh)
it computes the per-device working set analytically and, when it exceeds
the device's memory, applies the paper's advises in priority order:

  1. int8 optimizer moments    (shrink before moving — beyond-paper)
  2. optimizer state -> HOST   (PREFERRED_LOCATION(HOST) + ACCESSED_BY(DEVICE),
                                the ZeRO-Offload pattern: pinned host memory,
                                fetched for the update and evicted after it)
  3. activation remat->offload (recompute + host-stage long-lived residuals)
  4. KV cache -> paged host tier (decode only)

The emitted ``ResidencyPlan`` is consumed by ``launch/step.py``.  The budget
accounts for the reference's production mesh only (``MeshConfig``: 16 x 16,
or 2 x 16 x 16), so it cannot plan for one card, though the port's steps
run on a one-device ``DeviceMesh`` (``launch/mesh.py``).  The capacity per device is the card's memory
(``torch.cuda.get_device_properties``) unless the caller gives
``hbm_bytes``; the planner states no size of its own.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, MeshConfig, ShapeConfig
from repro_torch.core.advise import MemorySpace
from repro_torch.device import resolve

GB = 1024**3


# ---------------------------------------------------------------------------
# Vectorized residency order (consumed by repro_torch.core.simulator)
# ---------------------------------------------------------------------------
#
# The seed simulator kept two OrderedDicts — an unpinned queue (evicted
# first) and a pinned queue (last resort) — and popped chunks one at a time.
# The vectorized engine replaces queue *position* with a monotonically
# increasing int64 stamp per resident chunk: insertion and LRU-touch both
# assign the next stamp, so ascending stamp order within a queue is exactly
# the OrderedDict pop order.  Victim selection then becomes an argsort plus
# a cumulative-sum cut instead of a per-chunk pop loop.

def victim_order(stamp: np.ndarray, in_pin_queue: np.ndarray,
                 pinned_now: np.ndarray) -> tuple[np.ndarray, bool]:
    """Seed-equivalent eviction order over gathered resident chunks.

    Returns ``(order, anomaly)`` where ``order`` indexes the gathered arrays
    in the order the seed model would pop them: the unpinned queue in stamp
    order, then the pinned queue in stamp order.  ``anomaly`` is True when
    any chunk's queue membership disagrees with its region's *current* pin
    state — the seed reclassifies such chunks lazily at pop time, which the
    batched cut cannot reproduce, so callers must take a scalar path.
    """
    anomaly = bool(np.any(in_pin_queue != pinned_now))
    un = np.nonzero(~in_pin_queue)[0]
    pin = np.nonzero(in_pin_queue)[0]
    # stable (timsort) exploits the near-sorted runs that per-region batch
    # insertion produces — measurably faster than quicksort here
    order = np.concatenate(
        [un[np.argsort(stamp[un], kind="stable")],
         pin[np.argsort(stamp[pin], kind="stable")]]
    )
    return order, anomaly


def eviction_cut(sizes_in_order: np.ndarray, need_free: int) -> int | None:
    """How many victims (a prefix of the pop order) free ``need_free`` bytes.

    Mirrors the seed's ``while used + need > capacity: pop()`` loop: the
    minimal prefix whose byte sum reaches ``need_free``.  Returns None when
    even evicting everything falls short (the seed then raises
    OversubscriptionError after draining both queues).
    """
    if need_free <= 0:
        return 0
    csum = np.cumsum(sizes_in_order)
    if len(csum) == 0 or int(csum[-1]) < need_free:
        return None
    return int(np.searchsorted(csum, need_free, side="left")) + 1


# ---------------------------------------------------------------------------
# Incremental residency index (DESIGN.md §9)
# ---------------------------------------------------------------------------
#
# victim_order/eviction_cut above still *re-derive* the pop order from
# per-chunk stamps on every eviction plan: O(resident) gather + argsort per
# plan.  The index below maintains the pop order *persistently*: each queue
# (unpinned first, pinned last-resort — the seed's two OrderedDicts) is an
# append-only array of RUN entries (region, start, length, uniform chunk
# size).  Stamps are handed out monotonically, so append order IS stamp
# order and no sort ever happens; contiguous chunks inserted together form
# one entry instead of ``length`` array slots (~400k 64 KB pages per region
# collapse to a handful of runs).  Chunks leave lazily: the owning region
# maps each chunk to its entry (``Region.entry_ptr``), removal decrements
# the entry's live count, and clean prefix/suffix removals shrink the run
# window in place so streaming eviction never fragments an entry.

class RunQueue:
    """One residency queue as an append-ordered array of chunk runs.

    Entry ``e`` covers region ``reg[e]`` chunks ``[start[e], start[e] +
    length[e])``, every chunk of uniform size ``csize[e]``; ``nlive[e]`` of
    them are still members.  Liveness of an individual chunk is owned by the
    region's ``entry_ptr`` (it points back at ``e`` iff the chunk is still
    filed under this entry); ``nlive < length`` marks entries whose live
    members must be re-derived from ``entry_ptr`` (scattered partial
    removal — rare, see ``remove``).

    Invariant: concatenating live members of entries ``head..tail`` in entry
    order, ascending chunk id within an entry, yields exactly the seed
    OrderedDict's pop order for this queue.
    """

    __slots__ = ("qi", "reg", "start", "length", "nlive", "csize",
                 "head", "tail", "live_chunks", "live_bytes")

    def __init__(self, qi: int, cap: int = 64):
        self.qi = qi                    # 0 = unpinned, 1 = pinned
        self.reg = np.zeros(cap, dtype=np.int64)
        self.start = np.zeros(cap, dtype=np.int64)
        self.length = np.zeros(cap, dtype=np.int64)
        self.nlive = np.zeros(cap, dtype=np.int64)
        self.csize = np.zeros(cap, dtype=np.int64)
        self.head = 0
        self.tail = 0
        self.live_chunks = 0
        self.live_bytes = 0

    # -- growth & compaction ---------------------------------------------------
    def _entries_alive(self) -> np.ndarray:
        sl = slice(self.head, self.tail)
        return np.flatnonzero(self.nlive[sl] > 0) + self.head

    def _ensure(self, n: int, regions) -> None:
        if self.tail + n <= len(self.reg):
            return
        alive = self._entries_alive()
        if len(alive) * 2 <= self.tail:     # mostly dead: compact in place
            self.compact(regions, alive)
            if self.tail + n <= len(self.reg):
                return
        cap = max(self.tail + n, 2 * len(self.reg))
        for name in ("reg", "start", "length", "nlive", "csize"):
            old = getattr(self, name)
            new = np.zeros(cap, dtype=np.int64)
            new[:self.tail] = old[:self.tail]
            setattr(self, name, new)

    def compact(self, regions, alive: np.ndarray | None = None) -> None:
        """Drop dead entries, renumbering the survivors and re-pointing the
        affected regions' ``entry_ptr`` — order (and thus pop order) is
        preserved.  Adjacent mergeable survivors (same region, same chunk
        size, fully live, contiguous) coalesce into one run: removing the
        dead entries between them is exactly what makes them adjacent, and
        the merged entry pops the same chunk sequence the pair did.
        O(live chunks of surviving entries), amortized by the doubling
        growth policy."""
        if alive is None:
            alive = self._entries_alive()
        w = 0
        for old_e in alive.tolist():
            rg = int(self.reg[old_e])
            s = int(self.start[old_e])
            ln = int(self.length[old_e])
            nl = int(self.nlive[old_e])
            cz = int(self.csize[old_e])
            if (w > 0 and nl == ln
                    and int(self.nlive[w - 1]) == int(self.length[w - 1])
                    and int(self.reg[w - 1]) == rg
                    and int(self.csize[w - 1]) == cz
                    and int(self.start[w - 1]) + int(self.length[w - 1]) == s):
                win = regions[rg].entry_ptr[s:s + ln]
                win[win == old_e * 2 + self.qi] = (w - 1) * 2 + self.qi
                self.length[w - 1] += ln
                self.nlive[w - 1] += ln
                continue
            if w != old_e:
                self.reg[w] = rg
                self.start[w] = s
                self.length[w] = ln
                self.nlive[w] = nl
                self.csize[w] = cz
                win = regions[rg].entry_ptr[s:s + ln]
                win[win == old_e * 2 + self.qi] = w * 2 + self.qi
            w += 1
        self.head = 0
        self.tail = w

    # -- membership ------------------------------------------------------------
    def append(self, reg: int, starts, lengths, csizes, regions) -> None:
        """File runs at the tail (stamp order == append order).  ``starts``/
        ``lengths``/``csizes`` are parallel per-run arrays for ONE region.

        Run coalescing (DESIGN.md §14): when the first incoming run extends
        the tail entry — same region, same chunk size, fully live, and
        chunk-contiguous — it merges into it instead of opening a new entry.
        The merged chunks carry the newest stamps and the tail entry pops
        last, so the pop order is bit-identical; what changes is that
        streaming producers (consecutive fault batches walking one region)
        stay O(1) entries instead of one entry per batch."""
        n = len(starts)
        if not n:
            return
        t = self.tail
        if t > self.head:
            e = t - 1
            if (int(self.reg[e]) == reg
                    and int(self.csize[e]) == int(csizes[0])
                    and int(self.nlive[e]) == int(self.length[e])
                    and int(self.start[e]) + int(self.length[e])
                    == int(starts[0])):
                s0, ln0 = int(starts[0]), int(lengths[0])
                self.length[e] += ln0
                self.nlive[e] += ln0
                regions[reg].entry_ptr[s0:s0 + ln0] = e * 2 + self.qi
                self.live_chunks += ln0
                self.live_bytes += ln0 * int(csizes[0])
                starts, lengths, csizes = starts[1:], lengths[1:], csizes[1:]
                n -= 1
                if not n:
                    return
        self._ensure(n, regions)
        t = self.tail
        self.reg[t:t + n] = reg
        self.start[t:t + n] = starts
        self.length[t:t + n] = lengths
        self.nlive[t:t + n] = lengths
        self.csize[t:t + n] = csizes
        self.tail = t + n
        r = regions[reg]
        for k in range(n):
            s, ln = int(starts[k]), int(lengths[k])
            r.entry_ptr[s:s + ln] = (t + k) * 2 + self.qi
            self.live_chunks += ln
            self.live_bytes += ln * int(csizes[k])

    def remove(self, e: int, cnt: int, id_min: int, id_max: int) -> None:
        """Un-file ``cnt`` chunks (ids spanning [id_min, id_max]) from entry
        ``e``.  The caller has already cleared their ``entry_ptr``.  Clean
        prefix/suffix removals shrink the run window so the entry stays
        fully live (streaming eviction consumes queue prefixes — the common
        case); anything else just decrements ``nlive`` and the entry's live
        members are re-derived from ``entry_ptr`` when next gathered."""
        s = int(self.start[e])
        ln = int(self.length[e])
        nl = int(self.nlive[e])
        self.live_chunks -= cnt
        self.live_bytes -= cnt * int(self.csize[e])
        if cnt == nl:
            self.nlive[e] = 0
            if e == self.head:
                h, t, nlv = self.head, self.tail, self.nlive
                while h < t and nlv[h] == 0:
                    h += 1
                self.head = h
            return
        contiguous = cnt == id_max - id_min + 1
        if contiguous and nl == ln and id_min == s:            # prefix
            self.start[e] = s + cnt
            self.length[e] = ln - cnt
            self.nlive[e] = nl - cnt
        elif contiguous and nl == ln and id_max == s + ln - 1:  # suffix
            self.length[e] = ln - cnt
            self.nlive[e] = nl - cnt
        else:                                                   # scattered
            self.nlive[e] = nl - cnt

    def front(self, regions):
        """``(reg, chunk_id)`` of this queue's pop-front live chunk — the
        lowest-stamp chunk it holds (queue order IS stamp order, the
        audited ``stamp_order`` invariant) — or None when empty.  Advances
        the dead-head scan as a side effect.  Within an entry the live
        chunk with the smallest id carries the smallest stamp: entries are
        appended as ascending contiguous runs with ascending stamps, and
        tail merges only ever extend an entry upward in both id and
        stamp."""
        h, t = self.head, self.tail
        nlv = self.nlive
        while h < t and nlv[h] == 0:
            h += 1
        self.head = h
        if h >= t:
            return None
        rg = int(self.reg[h])
        s = int(self.start[h])
        ln = int(self.length[h])
        if int(nlv[h]) == ln:
            return rg, s
        win = regions[rg].entry_ptr[s:s + ln]
        return rg, s + int(np.argmax(win == h * 2 + self.qi))

    # -- gather ----------------------------------------------------------------
    def live_runs(self, regions):
        """Materialize the queue's pop order as runs: parallel arrays
        (reg, start, count, csize).  Fully-live entries pass through
        directly; partially-live entries expand into their live sub-runs by
        scanning ``entry_ptr`` over the entry's window (rare)."""
        alive = self._entries_alive()
        if not len(alive):
            z = np.zeros(0, dtype=np.int64)
            return z, z, z, z
        nl = self.nlive[alive]
        if np.array_equal(nl, self.length[alive]):   # no partial entries
            return (self.reg[alive], self.start[alive],
                    self.length[alive].copy(), self.csize[alive])
        regs, starts, cnts, csz = [], [], [], []
        for e in alive.tolist():
            s = int(self.start[e])
            ln = int(self.length[e])
            c = int(self.csize[e])
            rg = int(self.reg[e])
            if self.nlive[e] == ln:
                regs.append(rg); starts.append(s); cnts.append(ln)
                csz.append(c)
                continue
            r = regions[rg]
            pos = np.flatnonzero(
                r.entry_ptr[s:s + ln] == e * 2 + self.qi) + s
            brk = np.flatnonzero(np.diff(pos) != 1) + 1
            bounds = np.concatenate([[0], brk, [len(pos)]])
            for a, b in zip(bounds[:-1].tolist(), bounds[1:].tolist()):
                regs.append(rg); starts.append(int(pos[a]))
                cnts.append(b - a); csz.append(c)
        return (np.array(regs, dtype=np.int64),
                np.array(starts, dtype=np.int64),
                np.array(cnts, dtype=np.int64),
                np.array(csz, dtype=np.int64))


class ResidencyIndex:
    """The two seed queues (unpinned evicted-first, pinned last-resort) as
    :class:`RunQueue` pairs, plus the cross-queue helpers the simulator's
    eviction planner consumes.  ``regions`` is the simulator's region list
    in allocation order; entries refer to regions by that slot."""

    def __init__(self):
        self.un = RunQueue(0)
        self.pin = RunQueue(1)

    def queue(self, qi: int) -> RunQueue:
        return self.pin if qi else self.un

    @property
    def live_chunks(self) -> int:
        return self.un.live_chunks + self.pin.live_chunks

    def pop_runs(self, regions):
        """The global pop order as runs: unpinned queue then pinned queue.
        Returns ``(regs, starts, counts, csizes, n_un_runs)`` or None when
        nothing is resident."""
        if not self.live_chunks:
            return None
        ur, us, uc, uz = self.un.live_runs(regions)
        pr, ps, pc, pz = self.pin.live_runs(regions)
        return (np.concatenate([ur, pr]), np.concatenate([us, ps]),
                np.concatenate([uc, pc]), np.concatenate([uz, pz]),
                len(ur))

    def remove_runs(self, regions, regs, starts, cnts) -> None:
        """Batched un-filing of victim runs (the hot eviction path).

        Each run came off :meth:`pop_runs`, so it lives entirely inside one
        queue entry (``live_runs`` never crosses entry boundaries): per run
        this is O(1) bookkeeping plus one ``entry_ptr`` slice clear, with the
        run-window shrink rules of :meth:`RunQueue.remove`.  Live counters
        and the dead-head scan are settled once per queue at the end instead
        of per removal — batch run replacement, not per-entry Python."""
        touched = [False, False]
        rm_chunks = [0, 0]
        rm_bytes = [0, 0]
        for k in range(len(regs)):
            r = regions[int(regs[k])]
            s, c = int(starts[k]), int(cnts[k])
            e0 = int(r.entry_ptr[s])
            r.entry_ptr[s:s + c] = -1
            qi = e0 & 1
            e = e0 >> 1
            q = self.pin if qi else self.un
            nl = int(q.nlive[e])
            ln = int(q.length[e])
            if c == nl:
                q.nlive[e] = 0
            elif nl == ln and int(q.start[e]) == s:              # prefix
                q.start[e] = s + c
                q.length[e] = ln - c
                q.nlive[e] = nl - c
            elif nl == ln and s + c == int(q.start[e]) + ln:     # suffix
                q.length[e] = ln - c
                q.nlive[e] = nl - c
            else:                                                # scattered
                q.nlive[e] = nl - c
            rm_chunks[qi] += c
            rm_bytes[qi] += c * int(q.csize[e])
            r.q_live[qi] -= c
            touched[qi] = True
        for qi in (0, 1):
            if not touched[qi]:
                continue
            q = self.pin if qi else self.un
            q.live_chunks -= rm_chunks[qi]
            q.live_bytes -= rm_bytes[qi]
            h, t, nlv = q.head, q.tail, q.nlive
            while h < t and nlv[h] == 0:
                h += 1
            q.head = h


def chunk_runs(ids: np.ndarray, sizes: np.ndarray):
    """Split ``ids`` (in insertion order) into maximal runs of consecutive
    ascending chunk ids with uniform chunk size.  ``sizes`` is the per-chunk
    size array aligned with ``ids``, drawn from one region's size array —
    uniform chunks with at most one odd FINAL chunk (the allocation
    invariant the fast paths below rely on).  Within ``ids`` each maximal
    ascending stretch must be sorted (every producer walks chunks in
    ascending or wrapped-ascending order).  Returns (starts, lengths,
    csizes)."""
    n = len(ids)
    if not n:
        z = np.zeros(0, dtype=np.int64)
        return z, z, z
    if n == 1:
        return (np.array([ids[0]], dtype=np.int64),
                np.array([1], dtype=np.int64),
                np.array([sizes[0]], dtype=np.int64))
    if int(ids[-1]) - int(ids[0]) == n - 1 and sizes[0] == sizes[n - 2]:
        # contiguous ascending window of one region: sizes comes from the
        # region's per-chunk size array, where only the FINAL chunk may
        # differ from the uniform chunk size (the allocation invariant) —
        # so the second-to-last element witnesses body uniformity and the
        # only possible break is before the last element.  No full-array
        # scan or diff on the hot megachunk paths.
        if sizes[n - 1] == sizes[0]:
            return (np.array([ids[0]], dtype=np.int64),
                    np.array([n], dtype=np.int64),
                    np.array([sizes[0]], dtype=np.int64))
        return (np.array([ids[0], int(ids[0]) + n - 1], dtype=np.int64),
                np.array([n - 1, 1], dtype=np.int64),
                np.array([sizes[0], sizes[n - 1]], dtype=np.int64))
    brk = np.flatnonzero((np.diff(ids) != 1) | (np.diff(sizes) != 0)) + 1
    bounds = np.concatenate([[0], brk, [len(ids)]])
    starts = ids[bounds[:-1]]
    lengths = np.diff(bounds)
    return (starts.astype(np.int64), lengths.astype(np.int64),
            sizes[bounds[:-1]].astype(np.int64))


def expand_runs(starts: np.ndarray, cnts: np.ndarray):
    """Chunk ids covered by runs, concatenated in run order: O(total) numpy."""
    total = int(cnts.sum())
    if not total:
        return np.zeros(0, dtype=np.int64)
    ends = np.cumsum(cnts)
    within = np.arange(total, dtype=np.int64) - np.repeat(ends - cnts, cnts)
    return np.repeat(starts, cnts) + within


def counter_promote_split(ids: np.ndarray, counts: np.ndarray,
                          threshold: float):
    """One remote-access round of per-chunk access counters (DESIGN.md §10,
    the Grace-Hopper hybrid tier): increment ``counts`` for the remote-touched
    ``ids``, then split them into ``(hot, cold)``.  Hot chunks reached
    ``threshold`` touches — they are promoted (migrated) by the caller and
    their counters reset, mirroring hardware counters that clear when they
    fire, so a chunk evicted after promotion starts cold again and the
    oversubscription cliff returns gradually.  Cold chunks stay remote.

    ``threshold == 0`` (or 1) promotes on the first touch — on-demand UM;
    ``threshold == inf`` never promotes — the pure remote tier.  Hot and
    cold keep ``ids`` order, so every maximal ascending stretch stays
    sorted and the batched promotion path (``chunk_runs``) coalesces them
    into runs."""
    counts[ids] += 1
    if math.isinf(threshold):
        return ids[:0], ids
    hot_mask = counts[ids] >= threshold
    hot = ids[hot_mask]
    counts[hot] = 0
    return hot, ids[~hot_mask]


# -- exact run-level replay of the seed's interleaved insert/pop loop ---------
#
# When an inserting batch overflows what the old queues can cover, the seed
# pops victims *interleaved* with the batch's own insertions (a chunk
# inserted early in the batch can be evicted by a later chunk of the same
# batch — the streaming-thrash regime).  merge_pop_chunks below is the
# per-chunk reference replay (the pre-index implementation, kept as the
# oracle for property tests); merge_pop_runs reproduces its exact output in
# O(runs) by exploiting that chunk sizes are uniform within a run: a pop
# and an insert of equal size leave the free-byte count unchanged, so whole
# run pairs consume each other 1-for-1 in closed form, and only run
# boundaries/odd-sized tail chunks step chunk-at-a-time.

def merge_pop_chunks(own_sizes, un_sizes, pin_sizes, free, region_pinned):
    """Reference chunk-level replay.  Returns ``(vict, m)`` where ``vict``
    holds the pop sequence (>=0: old-queue position in un-then-pin order;
    ``~j``: the batch's own chunk j) and ``m[i]`` counts victims consumed
    through chunk i's insertion — or None when every queue drains (the seed
    raises mid-batch)."""
    n_un = len(un_sizes)
    osz = list(un_sizes) + list(pin_sizes)
    n_old = len(osz)
    szl = list(own_sizes)
    n_own = len(szl)
    vict: list[int] = []
    m = np.zeros(n_own, dtype=np.int64)
    un_cur, pin_cur, own_cur = 0, n_un, 0
    for i in range(n_own):
        s = szl[i]
        while free < s:
            if un_cur < n_un:
                free += osz[un_cur]
                vict.append(un_cur)
                un_cur += 1
            elif not region_pinned and own_cur < i:
                free += szl[own_cur]
                vict.append(~own_cur)
                own_cur += 1
            elif pin_cur < n_old:
                free += osz[pin_cur]
                vict.append(pin_cur)
                pin_cur += 1
            elif region_pinned and own_cur < i:
                free += szl[own_cur]
                vict.append(~own_cur)
                own_cur += 1
            else:
                return None
        free -= s
        m[i] = len(vict)
    return np.array(vict, dtype=np.int64), m


class _RunStream:
    """Cursor over a (csize, count) run list: peek current size/availability,
    consume k chunks."""

    __slots__ = ("csize", "count", "ri", "within", "consumed")

    def __init__(self, csizes, counts):
        self.csize = [int(c) for c in csizes]
        self.count = [int(c) for c in counts]
        self.ri = 0
        self.within = 0
        self.consumed = 0

    def peek(self):
        """(size, available_in_run) or (0, 0) when exhausted."""
        while self.ri < len(self.count) and \
                self.within >= self.count[self.ri]:
            self.ri += 1
            self.within = 0
        if self.ri >= len(self.count):
            return 0, 0
        return self.csize[self.ri], self.count[self.ri] - self.within

    def take(self, k: int) -> None:
        self.within += k
        self.consumed += k


def merge_pop_runs(own_runs, un_runs, pin_runs, free, region_pinned):
    """Run-level equivalent of :func:`merge_pop_chunks`.

    ``own_runs``/``un_runs``/``pin_runs`` are (csizes, counts) pairs.
    Returns ``(segments, m_segs, n_un_taken, n_pin_taken, n_own_taken)``:
    ``segments`` is the pop sequence as (source, offset, count) triples
    (source in {"un", "pin", "own"}; offset = chunks already consumed from
    that source), ``m_segs`` encodes the per-insert victim counts as
    (i0, count, m0, step) records — m[i0 + t] = m0 + step * t.  Returns
    None when the seed would raise mid-batch (all sources drained)."""
    ins = _RunStream(*own_runs)          # insert side of the batch
    own = _RunStream(*own_runs)          # the batch's own chunks as victims
    un = _RunStream(*un_runs)
    pin = _RunStream(*pin_runs)
    n_own = sum(int(c) for c in own_runs[1])
    free = int(free)
    segments: list[tuple[str, int, int]] = []
    m_segs: list[tuple[int, int, int, int]] = []
    i = 0                                # inserts completed
    V = 0                                # victims popped
    while i < n_own:
        s, ins_avail = ins.peek()
        if free >= s:
            # pop-free prefix: inserts while free stays >= s
            k = min(free // s, ins_avail)
            m_segs.append((i, k, V, 0))
            ins.take(k)
            i += k
            free -= k * s
            continue
        # seed priority: old unpinned, then (unpinned region) own, then old
        # pinned, then (pinned region) own — else the seed raises.  The gap
        # i - own.consumed (inserted-but-not-yet-popped own chunks) gates
        # own availability.
        gap = i - own.consumed
        v, avail = un.peek()
        src, stream = "un", un
        if not avail and not region_pinned and gap:
            v, avail = own.peek()
            src, stream = "own", own
        if not avail:
            v, avail = pin.peek()
            src, stream = "pin", pin
        if not avail and region_pinned and gap:
            v, avail = own.peek()
            src, stream = "own", own
        if not avail:
            return None
        if v == s:
            # equal sizes: each insert pops exactly one victim (free < s
            # and free + v >= s), free is a fixed point — consume run pairs
            # 1-for-1.  An own-victim segment keeps the gap constant (both
            # cursors advance), so it never exhausts mid-segment.
            k = min(ins_avail, avail)
            if src == "pin" and not region_pinned:
                # an unpinned region's own chunks outrank the pinned queue,
                # and completing this insert makes one available (the gap
                # becomes >= 1): re-evaluate after one insert
                k = 1
            segments.append((src, stream.consumed, k))
            stream.take(k)
            ins.take(k)
            m_segs.append((i, k, V + 1, 1))
            V += k
            i += k
            continue
        # size mismatch (region tail chunks): pop chunk-at-a-time from this
        # run for the single pending insert; own pops for one insert shrink
        # the gap, which caps them
        need_pop = s - free
        j = -(-need_pop // v)
        j = min(j, avail, gap) if src == "own" else min(j, avail)
        segments.append((src, stream.consumed, j))
        stream.take(j)
        free += j * v
        V += j
        if free >= s:
            free -= s
            m_segs.append((i, 1, V, 0))
            ins.take(1)
            i += 1
    return segments, m_segs, un.consumed, pin.consumed, own.consumed


def expand_m_segs(m_segs, n_own: int) -> np.ndarray:
    m = np.zeros(n_own, dtype=np.int64)
    for i0, cnt, m0, step in m_segs:
        if step:
            m[i0:i0 + cnt] = m0 + np.arange(cnt, dtype=np.int64)
        else:
            m[i0:i0 + cnt] = m0
    return m


HBM_HEADROOM = 0.92  # the caching allocator's fragmentation and workspaces
DTYPE_BYTES = {"bfloat16": 2, "float32": 4, "float16": 2, "int8": 1}


@dataclasses.dataclass
class MemoryBudget:
    """Per-device byte accounting, one entry per tensor role."""

    params: float = 0.0
    grads: float = 0.0
    opt_master: float = 0.0
    opt_moments: float = 0.0
    activations: float = 0.0
    kv_cache: float = 0.0
    embedding_io: float = 0.0   # logits/softmax working set

    def device_total(self, plan: "ResidencyPlan") -> float:
        t = self.params + self.grads + self.activations + self.embedding_io
        if plan.opt_space is MemorySpace.DEVICE:
            t += self.opt_master + self.opt_moments
        if not plan.kv_host_tier:
            t += self.kv_cache
        else:
            t += self.kv_cache * plan.kv_device_fraction
        return t

    def host_total(self, plan: "ResidencyPlan") -> float:
        t = 0.0
        if plan.opt_space is MemorySpace.HOST:
            t += self.opt_master + self.opt_moments
        if plan.kv_host_tier:
            t += self.kv_cache * (1 - plan.kv_device_fraction)
        return t

    def as_dict(self) -> dict[str, float]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class ResidencyPlan:
    arch: str
    shape: str
    mesh: MeshConfig
    budget: MemoryBudget
    opt_space: MemorySpace = MemorySpace.DEVICE
    int8_moments: bool = False
    remat: str = "full"
    kv_host_tier: bool = False
    kv_device_fraction: float = 1.0
    oversubscribed: bool = False          # working set > device memory before planning
    fits: bool = True                     # after planning
    decisions: list[str] = dataclasses.field(default_factory=list)

    @property
    def device_bytes(self) -> float:
        return self.budget.device_total(self)

    @property
    def host_bytes(self) -> float:
        return self.budget.host_total(self)

    def summary(self) -> dict:
        return {
            "arch": self.arch,
            "shape": self.shape,
            "mesh": "x".join(map(str, self.mesh.shape)),
            "device_gb": round(self.device_bytes / GB, 3),
            "host_gb": round(self.host_bytes / GB, 3),
            "oversubscribed": self.oversubscribed,
            "fits": self.fits,
            "opt_space": self.opt_space.value,
            "int8_moments": self.int8_moments,
            "remat": self.remat,
            "kv_host_tier": self.kv_host_tier,
            "decisions": list(self.decisions),
            "roles_gb": {k: round(v / GB, 3) for k, v in self.budget.as_dict().items()},
        }


class ResidencyPlanner:
    """Plans against ``hbm_bytes`` per device, or, when that is None, the
    memory of ``device`` (default: the card; raises without one).  On the
    CPU there is no device memory to read, so ``hbm_bytes`` is required."""

    def __init__(self, hbm_bytes: float | None = None, headroom: float = HBM_HEADROOM,
                 device=None):
        if hbm_bytes is None:
            dev = resolve(device)
            if dev.type != "cuda":
                raise ValueError(f"ResidencyPlanner: {dev} has no device memory to "
                                 "read; pass hbm_bytes")
            hbm_bytes = torch.cuda.get_device_properties(dev).total_memory
        self.capacity = hbm_bytes * headroom

    # -- working-set accounting -------------------------------------------------
    def _budget(self, arch: ArchConfig, shape: ShapeConfig, mesh: MeshConfig,
                *, int8_moments: bool, remat: str) -> MemoryBudget:
        m = arch.model
        b = MemoryBudget()
        pbytes = DTYPE_BYTES[m.dtype]
        n_param_shards = mesh.data_size // (mesh.shape[0] if mesh.multi_pod else 1) * mesh.model_size
        # params are sharded FSDP(data-within-pod) x TP(model); replicated across pods
        b.params = m.total_params() * pbytes / n_param_shards

        train = shape.kind == "train"
        if train:
            b.grads = b.params  # bf16 grads, reduce-scattered like params
            master = 4 if arch.train.master_dtype == "float32" else pbytes
            mom = 1 if int8_moments else 4
            # optimizer fully sharded over (data-within-pod x model)
            b.opt_master = m.total_params() * master / n_param_shards
            b.opt_moments = m.total_params() * 2 * mom / n_param_shards
            micro = max(1, arch.train.microbatches)
            tokens_per_dev = shape.tokens / mesh.data_size / micro
            # with full remat we keep one saved residual per layer (sequence-
            # sharded over model too) + one layer's recompute working set
            saves = m.num_layers * tokens_per_dev * m.d_model * pbytes / mesh.model_size
            layer_ws = tokens_per_dev * (4 * m.d_model + 2 * (m.d_ff if not m.num_experts else m.d_ff * m.top_k)) * pbytes / mesh.model_size
            if remat == "offload":
                saves = tokens_per_dev * m.d_model * pbytes / mesh.model_size * 2  # double buffer
            elif remat == "none":
                saves *= 6  # every sublayer output saved
            b.activations = saves + layer_ws
            # logits working set: tokens x vocab sharded over model
            b.embedding_io = tokens_per_dev * m.vocab_size * pbytes / mesh.model_size * m.num_codebooks
        else:
            tokens_per_dev = shape.tokens / mesh.data_size
            if shape.kind == "decode":
                tokens_per_dev = shape.global_batch / min(mesh.data_size, shape.global_batch)
            b.activations = tokens_per_dev * (6 * m.d_model + 2 * m.head_dim * max(m.num_heads, 1)) * pbytes / max(1, mesh.model_size // 4)
            b.embedding_io = tokens_per_dev * m.vocab_size * pbytes / mesh.model_size
            # KV cache (prefill builds it; decode holds it)
            eff_seq = shape.seq_len if m.sliding_window is None else min(shape.seq_len, m.sliding_window)
            if m.family == "ssm":
                kv_total = m.num_layers * shape.global_batch * (m.d_model * m.ssm_state + 2 * m.d_model) * 4
            else:
                kv_total = shape.global_batch * eff_seq * m.kv_bytes_per_token()
                if m.family == "hybrid":
                    kv_total += m.num_layers * shape.global_batch * (m.num_heads * m.head_dim * m.ssm_state) * 4
            # KV sharded over data (batch) and model (seq chunks / split-KV)
            kv_shards = min(mesh.data_size, shape.global_batch) * mesh.model_size
            b.kv_cache = kv_total / kv_shards
        return b

    # -- planning -----------------------------------------------------------------
    def plan(self, arch: ArchConfig, shape: ShapeConfig, mesh: MeshConfig) -> ResidencyPlan:
        um = arch.um
        int8 = arch.train.int8_moments
        remat = arch.train.remat
        budget = self._budget(arch, shape, mesh, int8_moments=int8, remat=remat)
        plan = ResidencyPlan(arch.name, shape.name, mesh, budget,
                             int8_moments=int8, remat=remat)

        naive = dataclasses.replace(plan, opt_space=MemorySpace.DEVICE,
                                    kv_host_tier=False)
        plan.oversubscribed = naive.device_bytes > self.capacity
        if plan.oversubscribed:
            plan.decisions.append(
                f"oversubscribed: naive working set "
                f"{naive.device_bytes / GB:.1f} GB > {self.capacity / GB:.1f} GB HBM"
            )

        if um.optimizer_offload == "on":
            plan.opt_space = MemorySpace.HOST
            plan.decisions.append("optimizer->host (forced by config)")

        # escalate until it fits (the paper's advise priority)
        if plan.device_bytes > self.capacity and shape.kind == "train":
            if not plan.int8_moments:
                plan.int8_moments = True
                plan.budget = self._budget(arch, shape, mesh, int8_moments=True, remat=plan.remat)
                plan.decisions.append("int8 optimizer moments (beyond-paper shrink-first)")
        if plan.device_bytes > self.capacity and shape.kind == "train" \
                and um.optimizer_offload in ("auto", "on"):
            if plan.opt_space is not MemorySpace.HOST:
                plan.opt_space = MemorySpace.HOST
                plan.decisions.append(
                    "optimizer state PREFERRED_LOCATION(HOST)+ACCESSED_BY(DEVICE) "
                    "(ZeRO-Offload pattern, streamed+double-buffered)"
                )
        if plan.device_bytes > self.capacity and shape.kind == "train":
            plan.remat = "offload"
            plan.budget = self._budget(arch, shape, mesh, int8_moments=plan.int8_moments, remat="offload")
            plan.decisions.append("activation remat -> host offload of residual saves")
        if plan.device_bytes > self.capacity and shape.kind == "decode":
            plan.kv_host_tier = True
            plan.kv_device_fraction = max(
                0.05,
                (self.capacity - (plan.device_bytes - plan.budget.kv_cache))
                / max(plan.budget.kv_cache, 1.0),
            )
            plan.decisions.append(
                f"KV cache paged host tier (device fraction "
                f"{plan.kv_device_fraction:.2f})"
            )
        if um.kv_host_tier and shape.kind == "decode" and not plan.kv_host_tier:
            plan.kv_host_tier = True
            plan.decisions.append("KV host tier (forced by config)")

        plan.fits = plan.device_bytes <= self.capacity
        if not plan.fits and um.oversubscription == "forbid":
            raise MemoryError(
                f"{arch.name}/{shape.name} does not fit and oversubscription "
                f"is forbidden: {plan.device_bytes / GB:.1f} GB"
            )
        if not plan.decisions:
            plan.decisions.append("fits in HBM; no offload required")
        return plan


def plan_cell(arch: ArchConfig, shape: ShapeConfig, mesh: MeshConfig, *,
              hbm_bytes: float | None = None, device=None) -> ResidencyPlan:
    return ResidencyPlanner(hbm_bytes, device=device).plan(arch, shape, mesh)
