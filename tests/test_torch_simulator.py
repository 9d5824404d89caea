"""The port's UM simulator (``repro_torch.core.simulator``), its
residency-order primitives (``core.residency``) and fault injector
(``core.faults``) against the JAX package's, which import no JAX either.

Exact parity: every call sequence runs on both engines, counters must be
int-equal and times within 1e-9 relative (``dataclasses.asdict`` of the
reports), residency order equal after every operation.  The two packages
have their own ``MemorySpace`` / ``Accessor`` classes, so each sequence is
written once against an engine namespace and runs with that engine's
enums; values are compared across packages, never identities.
"""
import dataclasses
import json
import math
import random
import types

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import advise as r_advise  # noqa: E402
from repro.core import faults as r_faults  # noqa: E402
from repro.core import residency as r_res  # noqa: E402
from repro.core import simulator as r_sim  # noqa: E402
from repro.umbench import platforms as r_plat  # noqa: E402
from repro_torch import core as p_core  # noqa: E402
from repro_torch.core import advise as p_advise  # noqa: E402
from repro_torch.core import faults as p_faults  # noqa: E402
from repro_torch.core import residency as p_res  # noqa: E402
from repro_torch.core import simulator as p_sim  # noqa: E402
from repro_torch.umbench import platforms as p_plat  # noqa: E402

REL = 1e-9


def engine(sim, advise, plat):
    return types.SimpleNamespace(
        UMSimulator=sim.UMSimulator, SimPlatform=sim.SimPlatform,
        OversubscriptionError=sim.OversubscriptionError,
        KB=sim.KB, MB=sim.MB, GB=sim.GB,
        MemorySpace=advise.MemorySpace, Accessor=advise.Accessor, plat=plat)


REF = engine(r_sim, r_advise, r_plat)
PORT = engine(p_sim, p_advise, p_plat)


def assert_close(got, want, ctx=""):
    """Ints (and bools) equal, floats within REL relative, recursively."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), ctx
        for k in want:
            assert_close(got[k], want[k], f"{ctx}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), ctx
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close(g, w, f"{ctx}[{i}]")
    elif isinstance(want, float):
        assert isinstance(got, float), (ctx, got, want)
        assert got == want or abs(got - want) <= REL * max(abs(got), abs(want)), \
            (ctx, got, want)
    else:
        assert type(got) is type(want) and got == want, (ctx, got, want)


def assert_same_report(got, want, ctx=""):
    assert_close(dataclasses.asdict(got), dataclasses.asdict(want), ctx)
    assert list(got.thrash.samples) == list(want.thrash.samples), ctx
    assert got.thrash.n_thrash_steps == want.thrash.n_thrash_steps, ctx


def on_both(build):
    """Run ``build(ns)`` once per engine; return (port result, ref result)."""
    return build(PORT), build(REF)


# ---------------------------------------------------------------------------
# residency-order primitives on seeded NumPy inputs
# ---------------------------------------------------------------------------

def _runs(rng, max_runs=4, max_count=12):
    n = rng.randint(0, max_runs)
    return (np.array([rng.choice([3, 5, 8]) for _ in range(n)], dtype=np.int64),
            np.array([rng.randint(1, max_count) for _ in range(n)], dtype=np.int64))


def _chunks(runs):
    return [int(c) for c, n in zip(*runs) for _ in range(int(n))]


@pytest.mark.parametrize("seed", range(100))
def test_merge_pop_matches_reference(seed):
    rng = random.Random(seed)
    own, un, pin = _runs(rng), _runs(rng), _runs(rng)
    free, pinned = rng.randint(-10, 60), rng.random() < 0.5
    args = (own, un, pin, free, pinned)
    got, want = p_res.merge_pop_runs(*args), r_res.merge_pop_runs(*args)
    assert (got is None) == (want is None)
    if want is not None:
        segs, m_segs, *counts = got
        assert segs == want[0] and m_segs == want[1] and counts == list(want[2:])
        assert np.array_equal(p_res.expand_m_segs(m_segs, int(own[1].sum())),
                              r_res.expand_m_segs(want[1], int(own[1].sum())))
    cargs = (_chunks(own), _chunks(un), _chunks(pin), free, pinned)
    got, want = p_res.merge_pop_chunks(*cargs), r_res.merge_pop_chunks(*cargs)
    assert (got is None) == (want is None)
    if want is not None:
        assert all(np.array_equal(g, w) and g.dtype == w.dtype
                   for g, w in zip(got, want, strict=True))


@pytest.mark.parametrize("seed", range(50))
def test_victim_order_and_cut_match_reference(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(0, 40))
    stamp = rng.permutation(n).astype(np.int64)
    in_pin = rng.random(n) < 0.4
    pinned_now = in_pin.copy()
    if seed % 3 == 0 and n:
        pinned_now[rng.integers(0, n)] ^= True     # a pin flip: the anomaly
    got, want = (p_res.victim_order(stamp, in_pin, pinned_now),
                 r_res.victim_order(stamp, in_pin, pinned_now))
    assert np.array_equal(got[0], want[0]) and got[1] == want[1]
    sizes = rng.integers(1, 64, n).astype(np.int64)
    for need in (-3, 0, 1, int(sizes.sum()) // 2, int(sizes.sum()),
                 int(sizes.sum()) + 1, int(rng.integers(0, 2000))):
        assert p_res.eviction_cut(sizes, need) == r_res.eviction_cut(sizes, need)


@pytest.mark.parametrize("seed", range(50))
def test_runs_and_counter_split_match_reference(seed):
    rng = np.random.default_rng(1000 + seed)
    region = np.full(200, 2 << 20, dtype=np.int64)
    region[-1] = 12345                                 # one odd final chunk
    n = int(rng.integers(0, 60))
    if seed % 3 == 0:                                  # a contiguous window
        lo = int(rng.integers(0, 200 - n + 1))
        ids = np.arange(lo, lo + n, dtype=np.int64)
    else:
        ids = np.sort(rng.choice(200, n, replace=False)).astype(np.int64)
    if seed % 2 and n:
        ids = np.roll(ids, int(rng.integers(0, n)))    # a wrapped partial walk
    sizes = region[ids]
    got, want = p_res.chunk_runs(ids, sizes), r_res.chunk_runs(ids, sizes)
    assert all(np.array_equal(g, w) and g.dtype == w.dtype
               for g, w in zip(got, want, strict=True))
    starts, cnts = want[0], want[1]
    assert np.array_equal(p_res.expand_runs(starts, cnts), r_res.expand_runs(starts, cnts))
    assert np.array_equal(p_res.expand_runs(starts, cnts), ids)
    counts_p = rng.integers(0, 3, 200).astype(np.int64)
    counts_r = counts_p.copy()
    for threshold in (0.0, 1.0, 2.0, 3.0, math.inf):
        got = p_res.counter_promote_split(ids, counts_p, threshold)
        want = r_res.counter_promote_split(ids, counts_r, threshold)
        assert all(np.array_equal(g, w) for g, w in zip(got, want, strict=True))
        assert np.array_equal(counts_p, counts_r)


# ---------------------------------------------------------------------------
# random call sequences: residency order, index invariants, reports
# ---------------------------------------------------------------------------

def _scenario(rng: random.Random):
    ops, names = [], []
    for i in range(rng.randint(2, 4)):
        nm = f"r{i}"
        names.append(nm)
        ops.append(("alloc", nm, rng.randint(3, 40) * 2**20 + rng.choice([0, 1, 517])))
        if rng.random() < 0.8:
            ops.append(("host_write", nm, None))
    for _ in range(rng.randint(2, 12)):
        k, nm = rng.random(), rng.choice(names)
        if k < 0.35:
            sub = rng.sample(names, rng.randint(1, len(names)))
            ops.append(("kernel", tuple(sub), tuple(n for n in sub if rng.random() < 0.3)))
        elif k < 0.5:
            ops.append(("pin", nm, rng.choice(["DEVICE", "HOST"])))
        elif k < 0.6:
            ops.append(("read_mostly", nm))
        elif k < 0.7:
            ops.append(("accessed_by", nm, rng.choice(["HOST", "DEVICE"])))
        elif k < 0.8:
            ops.append(("prefetch", nm, rng.choice(["DEVICE", "HOST"])))
        elif k < 0.9:
            ops.append(("host_write", nm, rng.randint(1, 20) * 2**20))
        else:
            ops.append(("host_read", nm, rng.randint(1, 20) * 2**20))
    return ops


def _apply(ns, sim, op):
    kind = op[0]
    if kind == "alloc":
        sim.alloc(op[1], op[2])
    elif kind == "host_write":
        sim.host_write(op[1], op[2])
    elif kind == "host_read":
        sim.host_read(op[1], op[2])
    elif kind == "kernel":
        sim.kernel("k", flops=1e6, reads=list(op[1]), writes=list(op[2]))
    elif kind == "pin":
        sim.advise_preferred_location(op[1], ns.MemorySpace[op[2]])
    elif kind == "read_mostly":
        sim.advise_read_mostly(op[1])
    elif kind == "accessed_by":
        sim.advise_accessed_by(op[1], ns.Accessor[op[2]])
    elif kind == "prefetch":
        sim.prefetch(op[1], ns.MemorySpace[op[2]])


@pytest.mark.parametrize("seed", range(60))
def test_random_sequences_match_reference(seed):
    """After every op of a random trace on a 128 MiB device: the same
    residency order, device bytes and raise; then the same report."""
    rng = random.Random(seed)
    ops = _scenario(rng)
    granularity = "page" if seed % 5 == 4 else "group"
    coherent = seed % 2 == 0
    fields = dict(name="nvlink" if coherent else "pcie", device_mem_gb=0.125,
                  link_bw_gbs=60.0 if coherent else 12.0, device_bw_gbs=500.0,
                  device_flops_tps=10.0, fault_latency_us=20.0 if coherent else 45.0,
                  host_can_access_device=coherent, device_can_access_host=True,
                  fault_migration_efficiency=0.85 if coherent else 0.35)
    sims = {id(ns): ns.UMSimulator(ns.SimPlatform(**fields), granularity=granularity)
            for ns in (PORT, REF)}
    sp, sr = sims[id(PORT)], sims[id(REF)]
    for op in ops:
        errs = []
        for ns, sim in ((PORT, sp), (REF, sr)):
            try:
                _apply(ns, sim, op)
                errs.append(None)
            except ns.OversubscriptionError as e:
                errs.append(str(e))
        assert errs[0] == errs[1], op
        sp._debug_validate()
        assert sp.residency_snapshot() == sr.residency_snapshot(), op
        assert sp.device_used == sr.device_used, op
        if errs[0] is not None:
            break
    assert_same_report(sp.finish(), sr.finish(), f"seed {seed}")


# ---------------------------------------------------------------------------
# the examples' sequences
# ---------------------------------------------------------------------------

def quickstart_advise(ns):
    out = []
    for platform in (ns.plat.INTEL_PASCAL, ns.plat.P9_VOLTA):
        for advised in (False, True):
            sim = ns.UMSimulator(platform)
            sim.alloc("inputs", 2 * 2**30, role="input")
            sim.host_write("inputs")
            sim.alloc("outputs", 2 * 2**29, role="output")
            if advised:
                sim.advise_read_mostly("inputs")
            for _ in range(4):
                sim.kernel("price", flops=5e9, reads=["inputs"], writes=["outputs"])
            sim.host_read("outputs")
            out.append(sim.finish())
    return out


def tour_advise(ns):
    out = []
    for oversub in (False, True):
        for platform in (ns.plat.INTEL_VOLTA, ns.plat.P9_VOLTA):
            for policy in ("none", "read_mostly", "preferred+accessed_by"):
                sim = ns.UMSimulator(platform)
                n = int(int(12 * ns.GB) * (1.5 if oversub else 0.8)) // 2
                sim.alloc("A", n, role="input")
                sim.alloc("B", n, role="output")
                if policy == "preferred+accessed_by":
                    sim.advise_preferred_location("A", ns.MemorySpace.DEVICE)
                    sim.advise_accessed_by("A", ns.Accessor.HOST)
                sim.host_write("A")
                if policy == "read_mostly":
                    sim.advise_read_mostly("A")
                for _ in range(4):
                    sim.kernel("k", flops=1e12, reads=["A"], writes=["B"])
                sim.host_read("B")
                out.append(sim.finish())
    return out


def demo_volta(ns):
    out = []
    for advise in (False, True):
        sim = ns.UMSimulator(ns.plat.INTEL_VOLTA)
        sim.alloc("weights", int(10 * ns.GB), role="weights")
        sim.alloc("kv", int(14 * ns.GB), role="kv_cache")
        sim.host_write("weights")
        if advise:
            sim.advise_read_mostly("weights")
        for _ in range(4):
            sim.kernel("decode", flops=2e12, reads=["weights", "kv"], writes=["kv"])
        out.append(sim.finish())
    return out


@pytest.mark.parametrize("build", (quickstart_advise, tour_advise, demo_volta),
                         ids=lambda f: f.__name__)
def test_example_sequences_match_reference(build):
    got, want = on_both(build)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_same_report(g, w, f"{build.__name__}[{i}]")


def test_examples_print_the_reference_numbers(capsys):
    """The port's examples print what the same sequences give on the
    reference engine (quickstart §1 and demo §4 line formats)."""
    from repro_torch.examples import oversubscribe_demo, quickstart

    rows = quickstart.advise_comparison()
    for (name, advised, report), want in zip(rows, quickstart_advise(REF), strict=True):
        assert_same_report(report, want, name)
    reports = oversubscribe_demo.volta_oversubscription()
    out = capsys.readouterr().out
    for (variant, report), want in zip(reports.items(), demo_volta(REF), strict=True):
        assert_same_report(report, want, variant)
        assert (f"  {variant:10s}: {want.total_s:6.2f} s (DtoH "
                f"{want.dtoh_bytes / r_sim.GB:5.1f} GB, evictions "
                f"{want.n_evictions})") in out


# ---------------------------------------------------------------------------
# eviction boundaries and raise sites (tests/test_eviction_boundaries.py,
# tests/test_oversubscription_raises.py) on both engines
# ---------------------------------------------------------------------------

def _tiny(ns, coherent=False, mem_gb=8 / 1024.0):
    return ns.SimPlatform("tiny", mem_gb, 60.0 if coherent else 12.0, 500.0, 10.0,
                          20.0 if coherent else 45.0, coherent, True)


def exact_fit(ns):
    sim = ns.UMSimulator(_tiny(ns))
    sim.alloc("a", 6 * ns.MB)
    sim.alloc("b", 4 * ns.MB)
    sim.host_write("a")
    sim.host_write("b")
    sim.kernel("k", flops=1.0, reads=["a"], writes=[])
    sim.kernel("k", flops=1.0, reads=["b"], writes=[])
    return sim


def odd_tail(ns):
    sim = ns.UMSimulator(_tiny(ns))
    sim.alloc("a", 5 * ns.MB + 64 * ns.KB)
    sim.alloc("b", 4 * ns.MB + 512)
    sim.host_write("a")
    sim.host_write("b")
    for nm in ("a", "b", "a"):
        sim.kernel("k", flops=1.0, reads=[nm], writes=[])
    return sim


def pinned_mix(ns):
    sim = ns.UMSimulator(_tiny(ns))
    sim.alloc("pinned", 4 * ns.MB)
    sim.advise_preferred_location("pinned", ns.MemorySpace.DEVICE)
    sim.alloc("plain", 4 * ns.MB)
    sim.host_write("pinned")
    sim.host_write("plain")
    sim.kernel("k", flops=1.0, reads=["pinned", "plain"], writes=[])
    sim.alloc("big", 7 * ns.MB)
    sim.advise_preferred_location("big", ns.MemorySpace.DEVICE)
    sim.host_write("big")
    sim.kernel("k", flops=1.0, reads=["big"], writes=[])
    return sim


def pin_flip(ns):
    sim = ns.UMSimulator(_tiny(ns, coherent=True))
    sim.alloc("a", 4 * ns.MB)
    sim.host_write("a")
    sim.kernel("k", flops=1.0, reads=["a"], writes=[])
    sim.advise_preferred_location("a", ns.MemorySpace.DEVICE)
    sim.alloc("b", 6 * ns.MB)
    sim.host_write("b")
    sim.kernel("k", flops=1.0, reads=["b"], writes=[])
    return sim


def unpin_flip(ns):
    sim = ns.UMSimulator(_tiny(ns, coherent=True))
    sim.alloc("a", 4 * ns.MB)
    sim.advise_preferred_location("a", ns.MemorySpace.DEVICE)
    sim.host_write("a")
    sim.kernel("k", flops=1.0, reads=["a"], writes=[])
    sim.advise_preferred_location("a", ns.MemorySpace.HOST)
    sim.alloc("b", 6 * ns.MB)
    sim.advise_preferred_location("b", ns.MemorySpace.DEVICE)
    sim.host_write("b")
    sim.kernel("k", flops=1.0, reads=["b"], writes=[])
    return sim


@pytest.mark.parametrize("build", (exact_fit, odd_tail, pinned_mix, pin_flip, unpin_flip),
                         ids=lambda f: f.__name__)
def test_eviction_boundaries_match_reference(build):
    sp, sr = on_both(build)
    sp._debug_validate()
    assert sp.residency_snapshot() == sr.residency_snapshot()
    assert sp.device_used == sr.device_used
    assert_same_report(sp.finish(), sr.finish(), build.__name__)


def explicit_alloc_raise(ns):
    sim = ns.UMSimulator(_tiny(ns))
    sim.alloc("a", 6 * ns.MB)
    sim.host_write("a")
    sim.kernel("k", flops=1.0, reads=["a"], writes=[])
    sim.alloc("w", 4 * ns.MB)
    return sim, lambda: sim.explicit_alloc("w")


def explicit_copy_raise(ns):
    sim = ns.UMSimulator(_tiny(ns))
    sim.alloc("a", int(1.5 * 8 / 1024.0 * ns.GB))
    sim.host_write("a")
    return sim, lambda: sim.explicit_copy_to_device("a")


def drain_then_raise(ns, flip=False):
    sim = ns.UMSimulator(_tiny(ns, mem_gb=1 / 1024.0))
    sim.alloc("small", 512 * ns.KB)
    sim.host_write("small")
    sim.kernel("k", flops=1.0, reads=["small"], writes=[])
    if flip:
        sim.advise_preferred_location("small", ns.MemorySpace.DEVICE)
    sim.alloc("big", 2 * ns.MB)
    sim.host_write("big")
    return sim, lambda: sim.kernel("k", flops=1.0, reads=["big"], writes=[])


def empty_drain_raise(ns):
    sim = ns.UMSimulator(_tiny(ns, mem_gb=1 / 1024.0))
    sim.alloc("big", 2 * ns.MB)
    sim.host_write("big")
    return sim, lambda: sim.kernel("k", flops=1.0, reads=["big"], writes=[])


@pytest.mark.parametrize("build", (
    explicit_alloc_raise, explicit_copy_raise, drain_then_raise,
    lambda ns: drain_then_raise(ns, flip=True), empty_drain_raise),
    ids=("explicit_alloc", "explicit_copy", "drain", "scalar_drain", "empty_drain"))
def test_raise_sites_match_reference(build):
    states = []
    for ns in (PORT, REF):
        sim, step = build(ns)
        with pytest.raises(ns.OversubscriptionError) as e:
            step()
        states.append((sim, str(e.value)))
    (sp, ep), (sr, er) = states
    assert ep == er
    assert sp.device_used == sr.device_used
    assert sp.residency_snapshot() == sr.residency_snapshot()
    assert_close(sp.t_device, sr.t_device)
    assert_close(dataclasses.asdict(sp.report), dataclasses.asdict(sr.report))


# ---------------------------------------------------------------------------
# access counters, page granularity, and the audit hook
# ---------------------------------------------------------------------------

def access_counters(ns, threshold, oversub, audit=False):
    sim = ns.UMSimulator(ns.plat.GRACE_HOPPER, audit=audit)
    total = int((1.5 if oversub else 0.5) * ns.plat.GRACE_HOPPER.device_mem_gb * ns.GB)
    sim.alloc("hot", total // 4, role="input")
    sim.alloc("cold", total - total // 4, role="input")
    for nm in ("hot", "cold"):
        sim.advise_preferred_location(nm, ns.MemorySpace.HOST)
        sim.advise_accessed_by(nm, ns.Accessor.DEVICE)
        sim.enable_access_counters(nm, threshold)
        sim.host_write(nm)
    for i in range(6):
        sim.kernel(f"pass{i}", flops=1e12, reads=["hot", "cold"], writes=[],
                   partial={"cold": 1 / 6})
    return sim


@pytest.mark.parametrize("threshold", (0.0, 1.0, 2.0, 3.0, math.inf))
@pytest.mark.parametrize("oversub", (False, True))
def test_access_counters_match_reference(threshold, oversub):
    sp, sr = on_both(lambda ns: access_counters(ns, threshold, oversub))
    assert sp.residency_snapshot() == sr.residency_snapshot()
    rp, rr = sp.finish(), sr.finish()
    assert_same_report(rp, rr)
    if 0 < threshold < math.inf:
        assert rp.n_promotions > 0


def page_cell(ns, policy, oversub):
    """The BS pattern at 64 KB pages on the 4 GiB Pascal."""
    sim = ns.UMSimulator(ns.plat.INTEL_PASCAL, granularity="page")
    nb = int((1.5 if oversub else 0.8) * 4 * ns.GB) // 5
    for nm in ("S", "X", "T", "CALL", "PUT"):
        sim.alloc(nm, nb)
    for nm in ("S", "X", "T"):
        sim.host_write(nm)
        if policy in ("advise", "both"):
            sim.advise_read_mostly(nm)
    if policy in ("prefetch", "both"):
        for nm in ("S", "X", "T"):
            sim.prefetch(nm)
    for _ in range(3):
        sim.kernel("bs", flops=60.0 * nb / 4, reads=["S", "X", "T"], writes=["CALL", "PUT"])
    sim.host_read("CALL")
    return sim


@pytest.mark.parametrize("policy", ("um", "advise", "prefetch", "both"))
@pytest.mark.parametrize("oversub", (False, True))
def test_page_granularity_matches_reference(policy, oversub):
    sp, sr = on_both(lambda ns: page_cell(ns, policy, oversub))
    assert sp.granularity == "page" and sp.device_used == sr.device_used
    assert_same_report(sp.finish(), sr.finish())


def test_audit_hook_runs_clean_and_equal():
    """The invariant audit checks every step and changes no number."""
    audited = access_counters(PORT, 2.0, True, audit=True)
    assert_same_report(audited.finish(), access_counters(REF, 2.0, True).finish())


# ---------------------------------------------------------------------------
# FaultInjector draws and injected runs
# ---------------------------------------------------------------------------

def test_scenario_tables_equal():
    assert p_faults.scenario_names() == r_faults.scenario_names()
    for name in r_faults.scenario_names():
        assert dataclasses.asdict(p_faults.get_scenario(name)) == \
            dataclasses.asdict(r_faults.get_scenario(name))
    assert set(p_core.SCENARIOS) == set(r_faults.SCENARIOS)


@pytest.mark.parametrize("name", sorted(r_faults.SCENARIOS))
@pytest.mark.parametrize("salt", ("", "bs:intel-pascal-pcie:um:oversubscribed:group",
                                  "cg:p9-volta-nvlink:um_advise:in_memory:page"))
def test_injector_draws_match_reference(name, salt):
    ip = p_faults.FaultInjector(p_faults.get_scenario(name), salt)
    ir = r_faults.FaultInjector(r_faults.get_scenario(name), salt)
    rng = random.Random(7)
    for _ in range(300):
        if rng.random() < 0.5:
            s = rng.uniform(1e-5, 1e-1)
            assert ip.transfer(s) == ir.transfer(s)
        else:
            n = rng.randint(0, 50)
            assert ip.fault_events(n) == ir.fault_events(n)
    assert p_faults._mix_seed(3, salt) == r_faults._mix_seed(3, salt)
    assert vars(ip).keys() == vars(ir).keys()


@pytest.mark.parametrize("name", sorted(r_faults.SCENARIOS))
def test_injected_sequence_matches_reference(name):
    reports = []
    for ns, fl in ((PORT, p_faults), (REF, r_faults)):
        sim = ns.UMSimulator(ns.plat.INTEL_VOLTA)
        sim.set_fault_injector(fl.FaultInjector(fl.get_scenario(name), "demo"))
        sim.alloc("weights", int(10 * ns.GB))
        sim.alloc("kv", int(14 * ns.GB))
        sim.host_write("weights")
        sim.prefetch("weights")
        for _ in range(4):
            sim.kernel("decode", flops=2e12, reads=["weights", "kv"], writes=["kv"])
        reports.append(sim.finish())
    assert_same_report(*reports, name)


# ---------------------------------------------------------------------------
# SimReport JSON, exports
# ---------------------------------------------------------------------------

def test_report_json_round_trips():
    got, want = on_both(lambda ns: access_counters(ns, 2.0, True).finish())
    text = json.dumps(got.to_json_dict())
    assert json.loads(text) == want.to_json_dict()
    back = p_sim.SimReport.from_json_dict(json.loads(text))
    assert dataclasses.asdict(back) == dataclasses.asdict(got)
    # a reference record decodes on the port, unknown keys ignored
    rec = dict(want.to_json_dict(), extra_key=1)
    assert dataclasses.asdict(p_sim.SimReport.from_json_dict(rec)) == \
        dataclasses.asdict(r_sim.SimReport.from_json_dict(rec))
    assert [f.name for f in dataclasses.fields(p_sim.SimReport)] == \
        [f.name for f in dataclasses.fields(r_sim.SimReport)]


def test_core_exports_match_reference():
    import repro.core as r_core
    names = ("GB", "KB", "MB", "OversubscriptionError", "Region", "SimPlatform",
             "SimReport", "ThrashWindow", "UMSimulator", "FaultInjector",
             "FaultScenario", "SCENARIOS", "get_scenario")
    for n in names:
        assert n in p_core.__all__ and hasattr(p_core, n), n
        assert getattr(p_core, n).__class__.__name__ == getattr(r_core, n).__class__.__name__
    assert (p_core.KB, p_core.MB, p_core.GB) == (r_core.KB, r_core.MB, r_core.GB)
    assert [f.name for f in dataclasses.fields(p_sim.SimPlatform)] == \
        [f.name for f in dataclasses.fields(r_sim.SimPlatform)]
    assert {m.name: m.value for m in p_advise.MemorySpace} == \
        {m.name: m.value for m in r_advise.MemorySpace}
