"""The port's serving tier (``repro_torch.umbench.serving``, DESIGN.md §13)
against the JAX package's, which imports no JAX either: every test of
tests/test_serving.py on the port (salted deterministic traffic, the
continuous-batching scheduler's KV-region lifecycle over ``sim.free``,
per-request latency metrics, journal round-trip of serving cells, the
SIGTERM-mid-sweep resume path), each held against the reference where it
computes something, then a fixed sample of the paper's serving sweep, four
fault-composed cells and the bounds-checked runner, whose reports must equal
the reference engine's exactly, and the cell cache's serving fingerprint.

The two packages have their own classes: cells are compared by their
``row()`` and by ``dataclasses.asdict`` of their reports.
"""
import dataclasses
import json
import os
import signal
import subprocess
import sys
import textwrap
import time

import pytest

from repro.core.simulator import UMSimulator as RUMSimulator
from repro.umbench import cellcache as r_cache
from repro.umbench import serving as r_srv
from repro.umbench.platforms import PLATFORMS as R_PLATFORMS
from repro.umbench.variants import get_strategy as r_get_strategy
from repro_torch.core.simulator import GB, UMSimulator
from repro_torch.umbench import cellcache as p_cache
from repro_torch.umbench.journal import SweepJournal, cell_key
from repro_torch.umbench.platforms import PLATFORMS
from repro_torch.umbench.serving import (
    PATTERNS,
    SERVING_REGIMES,
    ServingConfig,
    ServingReport,
    get_pattern,
    pattern_names,
    percentile,
    run_serving_cell,
    run_serving_specs,
    serve,
    serving_specs,
)
from repro_torch.umbench.variants import get_strategy, strategy_names

SMOKE = dict(pattern="poisson_short", platform="p9-volta-nvlink",
             regime="kv_150")


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SWEEP_PATTERNS = ("poisson", "bursty", "diurnal")
SWEEP_PLATFORMS = ("intel-volta-pcie", "p9-volta-nvlink")


def smoke_cell(variant="um", **over):
    kw = dict(SMOKE, **over)
    return run_serving_cell(kw["pattern"], variant, kw["platform"],
                            kw["regime"], faults=kw.get("faults"))


def as_dict(report):
    return None if report is None else dataclasses.asdict(report)


def assert_same_cell(got, want):
    """Port and reference serving cells: the same key, error and report,
    exactly (no tolerance: the port runs the same float operations)."""
    for f in ("app", "platform", "variant", "regime", "granularity", "faults",
              "error", "error_kind"):
        assert getattr(got, f) == getattr(want, f), f
    assert as_dict(got.report) == as_dict(want.report)
    assert got.row() == want.row()


# ---------------------------------------------------------------------------
# traffic generation
# ---------------------------------------------------------------------------

def test_traffic_deterministic_and_salt_separated():
    pat = get_pattern("poisson")
    a = pat.generate(salt="cell-A")
    b = pat.generate(salt="cell-A")
    c = pat.generate(salt="cell-B")
    assert a == b                       # same seed+salt: bit-identical
    assert a != c                       # the salt really separates streams
    assert len(a) == pat.n_requests
    arr = [r.arrival_s for r in a]
    assert arr == sorted(arr) and arr[0] >= 0.0
    for r in a:
        assert pat.prompt_clamp[0] <= r.prompt_len <= pat.prompt_clamp[1]
        assert pat.gen_clamp[0] <= r.gen_len <= pat.gen_clamp[1]
        assert r.total_tokens == r.prompt_len + r.gen_len
    for name in pattern_names():
        for salt in ("cell-A", "serve_poisson:p9-volta-nvlink:um:kv_150:group"):
            got = [dataclasses.astuple(r) for r in get_pattern(name).generate(salt)]
            want = [dataclasses.astuple(r)
                    for r in r_srv.get_pattern(name).generate(salt)]
            assert got == want, (name, salt)


def test_pattern_kinds_shape_arrivals():
    """Bursty gaps are burstier than Poisson's (higher squared coefficient
    of variation), and the diurnal modulation concentrates arrivals in the
    peak (sin > 0) half of each period while flat Poisson does not."""
    def gaps(name):
        out = []
        for i in range(20):         # pool salts: one 48-request trace is
            reqs = get_pattern(name).generate(salt=f"shape{i}")   # too noisy
            arr = [r.arrival_s for r in reqs]
            out += [b - a for a, b in zip(arr, arr[1:])]
        return out

    def cv2(xs):
        m = sum(xs) / len(xs)
        return sum((x - m) ** 2 for x in xs) / len(xs) / (m * m)

    assert cv2(gaps("bursty")) > 1.5 * cv2(gaps("poisson"))

    def peak_frac(name):
        period = get_pattern(name).period_s
        phases = [(r.arrival_s % period) / period
                  for i in range(20)
                  for r in get_pattern(name).generate(salt=f"shape{i}")]
        return sum(1 for p in phases if p < 0.5) / len(phases)

    assert peak_frac("diurnal") > 0.9       # load lives at the peak
    assert 0.35 < peak_frac("poisson") < 0.75   # flat: roughly even halves


def test_pattern_registry_resolution():
    assert set(pattern_names()) == set(PATTERNS)
    assert pattern_names() == r_srv.pattern_names()
    for name in PATTERNS:
        assert dataclasses.asdict(PATTERNS[name]) == \
            dataclasses.asdict(r_srv.PATTERNS[name])
    assert {"poisson", "bursty", "diurnal", "poisson_short"} <= set(PATTERNS)
    p = get_pattern("poisson")
    assert get_pattern(p) is p                       # object passthrough
    assert get_pattern("serve_poisson") is p         # app-label prefix
    with pytest.raises(KeyError):
        get_pattern("no_such_pattern")


# ---------------------------------------------------------------------------
# sim.free — the KV lifecycle primitive
# ---------------------------------------------------------------------------

def test_free_releases_device_residency():
    sim = UMSimulator(PLATFORMS["p9-volta-nvlink"])
    sim.alloc("kv", int(2 * GB), role="kv")
    sim.kernel("touch", flops=1e9, reads=["kv"], writes=[])
    assert sim.device_used > 0
    sim.free("kv")
    assert sim.device_used == 0
    assert "kv" not in sim.regions
    with pytest.raises(KeyError):
        sim.free("kv")


def test_free_then_realloc_same_name_is_fresh():
    sim = UMSimulator(PLATFORMS["p9-volta-nvlink"])
    sim.alloc("kv", int(1 * GB), role="kv")
    sim.kernel("t0", flops=1e9, reads=["kv"], writes=[])
    sim.free("kv")
    sim.alloc("kv", int(1 * GB), role="kv")
    r = sim.regions["kv"]
    assert not r.populated.any() and not r.resident_mask().any()
    # the fresh region faults in from scratch, alongside survivors
    sim.alloc("other", int(1 * GB), role="data")
    sim.kernel("t1", flops=1e9, reads=["kv", "other"], writes=[])
    rep = sim.finish()
    assert rep.total_s > 0 and sim.device_used > 0


def test_free_keeps_other_regions_consistent():
    """Freeing one region must not disturb another's residency accounting
    (the residency-index run entries encode region slots — the dead slot
    stays reserved)."""
    sim = UMSimulator(PLATFORMS["intel-volta-pcie"])
    sim.alloc("a", int(2 * GB), role="kv")
    sim.alloc("b", int(2 * GB), role="kv")
    sim.kernel("t", flops=1e9, reads=["a", "b"], writes=[])
    used_both = sim.device_used
    b_bytes = int(sim.regions["b"].sizes[
        sim.regions["b"].resident_mask()].sum())
    sim.free("a")
    assert sim.device_used == b_bytes
    assert used_both > b_bytes
    sim.kernel("t2", flops=1e9, reads=["b"], writes=[])
    assert sim.finish().total_s > 0


# ---------------------------------------------------------------------------
# the scheduler
# ---------------------------------------------------------------------------

def test_scheduler_serves_every_request_with_ordered_timelines():
    pat = get_pattern("poisson_short")
    reqs = pat.generate(salt="sched")
    sim = UMSimulator(PLATFORMS["p9-volta-nvlink"])
    sched = serve(sim, get_strategy("um"), reqs, kv_frac=1.5)
    assert len(sched.served) == len(reqs)
    assert sched.n_prefills == len(reqs)
    by_rid = {r.rid: r for r in sched.served}
    for req in reqs:
        s = by_rid[req.rid]
        assert req.arrival_s <= s.admit_s <= s.prefill_done_s <= s.finish_s
        assert (s.prompt_len, s.gen_len) == (req.prompt_len, req.gen_len)
    # every KV region was freed on retirement; only the weights shard lives
    assert set(sim.regions) == {"weights"}
    assert sched.n_decode_steps >= max(r.gen_len for r in reqs)
    rsim = RUMSimulator(R_PLATFORMS["p9-volta-nvlink"])
    rsched = r_srv.serve(rsim, r_get_strategy("um"),
                         r_srv.get_pattern("poisson_short").generate(salt="sched"),
                         kv_frac=1.5)
    assert [dataclasses.astuple(r) for r in sched.served] == \
        [dataclasses.astuple(r) for r in rsched.served]
    assert (sched.n_decode_steps, sched.n_prefills, sched.token_budget) == \
        (rsched.n_decode_steps, rsched.n_prefills, rsched.token_budget)
    assert dataclasses.asdict(sim.finish()) == dataclasses.asdict(rsim.finish())


def test_admission_respects_token_budget():
    """With a budget below two concurrent requests, the batch never holds
    more than one — FCFS admission blocks on the budget."""
    pat = get_pattern("poisson_short")
    reqs = pat.generate(salt="budget")
    cfg = ServingConfig(max_live_batches=1)
    sim = UMSimulator(PLATFORMS["p9-volta-nvlink"])
    sched = serve(sim, get_strategy("um"), reqs, kv_frac=1.5, config=cfg)
    assert len(sched.served) == len(reqs)
    # serialized: each request's decode finishes before the next admit
    order = sorted(sched.served, key=lambda r: r.admit_s)
    for prev, nxt in zip(order, order[1:]):
        assert nxt.admit_s >= prev.finish_s


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def test_percentile_interpolates():
    xs = [1.0, 2.0, 3.0, 4.0]
    assert percentile(xs, 0) == 1.0
    assert percentile(xs, 100) == 4.0
    assert percentile(xs, 50) == 2.5
    assert percentile([7.0], 99) == 7.0
    assert percentile([], 50) == 0.0
    import random
    rng = random.Random(5)
    for n in (1, 2, 7, 48):
        xs = [rng.expovariate(1.0) for _ in range(n)]
        for q in (0, 37.5, 50, 95, 99, 100):
            assert percentile(xs, q) == r_srv.percentile(xs, q)


def test_serving_report_json_roundtrip():
    cell = smoke_cell("um")
    rep = cell.report
    assert rep is not None
    back = ServingReport.from_json_dict(
        json.loads(json.dumps(rep.to_json_dict())))
    assert back == rep                  # full-precision dataclass equality
    ref = r_srv.ServingReport.from_json_dict(rep.to_json_dict())
    assert dataclasses.asdict(ref) == dataclasses.asdict(rep)
    assert [f.name for f in dataclasses.fields(ServingReport)] == \
        [f.name for f in dataclasses.fields(r_srv.ServingReport)]


# ---------------------------------------------------------------------------
# serving cells
# ---------------------------------------------------------------------------

def test_serving_cell_bit_for_bit_deterministic():
    a = smoke_cell("um")
    b = smoke_cell("um")
    assert a.report == b.report
    assert a.row() == b.row()


def test_ci_smoke_deterministic_p99_across_tiers():
    """The CI serving smoke: the short Poisson trace on um and the
    pipelined prefetch tier, each run twice — identical p99 both times."""
    for variant in ("um", "um_prefetch_pipelined"):
        a, b = smoke_cell(variant), smoke_cell(variant)
        assert a.report.ttft_p99_s == b.report.ttft_p99_s
        assert a.report.e2e_p99_s == b.report.e2e_p99_s
        assert a.report == b.report
        assert a.report.completed == a.report.n_requests


def test_kv_regimes_bind_oversubscription():
    """kv_100 fits (no evictions); kv_150 oversubscribes the full trace —
    eviction churn appears and goodput drops."""
    at = run_serving_cell("poisson", "um", "p9-volta-nvlink", "kv_100")
    over = run_serving_cell("poisson", "um", "p9-volta-nvlink", "kv_150")
    assert at.report.sim.n_evictions == 0
    assert over.report.sim.n_evictions > 0
    assert over.report.goodput_rps < at.report.goodput_rps
    assert over.report.e2e_p99_s > at.report.e2e_p99_s
    assert_same_cell(at, r_srv.run_serving_cell("poisson", "um", "p9-volta-nvlink",
                                                "kv_100"))


def test_explicit_na_under_kv_oversubscription():
    cell = run_serving_cell("poisson", "explicit", "p9-volta-nvlink",
                            "kv_200")
    assert cell.report is None and cell.error is None   # N/A, not a failure
    assert cell.row()["total_s"] is None


def test_platform_gate_na():
    for variant in ("svm_remote", "um_hybrid_counters"):
        cell = run_serving_cell("poisson_short", variant, "intel-volta-pcie",
                                "kv_100")
        assert cell.report is None and cell.error is None


def test_serving_cell_timeout_is_failure_record():
    cell = run_serving_cell("poisson", "um", "p9-volta-nvlink", "kv_200",
                            timeout_s=0.005)
    assert cell.report is None
    assert cell.error == "timeout after 0.005s"
    assert cell.row()["error"] == cell.error


def test_fault_scenario_composes_and_keys():
    """degraded_link under a thrashing serving cell (the poisson trace at
    kv_150 churns eviction/refault transfers, so the degraded-bandwidth
    windows actually open) slows the cell, keys separately in the journal,
    and stays deterministic."""
    kw = dict(pattern="poisson")
    clean = smoke_cell("um", **kw)
    degraded = smoke_cell("um", faults="degraded_link", **kw)
    assert degraded.faults == "degraded_link"
    assert cell_key(clean) != cell_key(degraded)
    assert degraded.report.sim.n_degraded_xfers > 0
    assert degraded.report.total_s > clean.report.total_s
    assert degraded.row()["fault_scenario"] == "degraded_link"
    again = smoke_cell("um", faults="degraded_link", **kw)
    assert again.report == degraded.report      # injection is salted too


# ---------------------------------------------------------------------------
# specs + journal
# ---------------------------------------------------------------------------

def test_serving_specs_cover_registry():
    specs = serving_specs(("poisson", "bursty"), ("p9-volta-nvlink",),
                          tuple(SERVING_REGIMES))
    assert len(specs) == 2 * 3 * len(strategy_names())
    apps = {s[0] for s in specs}
    assert apps == {"serve_poisson", "serve_bursty"}
    assert {s[3] for s in specs} == set(SERVING_REGIMES)
    assert SERVING_REGIMES == r_srv.SERVING_REGIMES
    assert specs == r_srv.serving_specs(("poisson", "bursty"), ("p9-volta-nvlink",),
                                        tuple(SERVING_REGIMES))
    assert serving_specs(("diurnal",), ("p9-volta-nvlink",), ("kv_150",),
                         faults="degraded_link") == \
        r_srv.serving_specs(("diurnal",), ("p9-volta-nvlink",), ("kv_150",),
                            faults="degraded_link")


def test_serving_journal_roundtrip_bit_identical(tmp_path):
    path = str(tmp_path / "serving.jsonl")
    cells = [smoke_cell(v) for v in ("um", "explicit", "um_prefetch")]
    with SweepJournal(path) as j:
        for c in cells:
            j.record(c)
    j2 = SweepJournal(path)
    for c in cells:
        back = j2.completed[cell_key(c)]
        assert type(back).__name__ == "ServingCellResult"
        assert back.report == c.report
        assert back.row() == c.row()


def test_serving_and_matrix_cells_share_a_journal(tmp_path):
    """The ``kind`` tag keeps the two cell families apart in one file: a
    mixed journal reconstructs each with its own report class."""
    from repro_torch.umbench.harness import run_cell
    path = str(tmp_path / "mixed.jsonl")
    mat = run_cell("bs", "um", "intel-pascal-pcie", "in_memory")
    srv = smoke_cell("um")
    with SweepJournal(path) as j:
        j.record(mat)
        j.record(srv)
    j2 = SweepJournal(path)
    assert type(j2.completed[cell_key(mat)]).__name__ == "CellResult"
    assert type(j2.completed[cell_key(srv)]).__name__ == "ServingCellResult"
    assert j2.completed[cell_key(srv)].report == srv.report


def test_run_serving_specs_resumes_from_journal(tmp_path):
    path = str(tmp_path / "serving.jsonl")
    specs = serving_specs(("poisson_short",), ("p9-volta-nvlink",),
                          ("kv_100", "kv_150"),
                          variants=("um", "um_prefetch", "explicit"))
    subset = specs[:2]
    with SweepJournal(path) as j:
        run_serving_specs(subset, journal=j)
        assert (j.reused, j.ran) == (0, 2)
    with SweepJournal(path) as j2:
        res = run_serving_specs(specs, journal=j2)
        assert (j2.reused, j2.ran) == (2, len(specs) - 2)
    fresh = run_serving_specs(specs)
    assert [c.row() for c in res] == [c.row() for c in fresh]
    for got, want in zip(res, r_srv.run_serving_specs(specs)):
        assert_same_cell(got, want)


# ---------------------------------------------------------------------------
# SIGTERM mid-serving-sweep, then resume
# ---------------------------------------------------------------------------

_SERVING_SWEEP_SCRIPT = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None
    from repro_torch.umbench.journal import SweepJournal
    from repro_torch.umbench.serving import run_serving_specs, serving_specs
    specs = serving_specs(("poisson", "diurnal"), ("p9-volta-nvlink",),
                          ("kv_150", "kv_200"),
                          variants=("um", "um_advise", "um_prefetch",
                                    "um_both"))
    with SweepJournal(sys.argv[1], resume=True) as j:
        run_serving_specs(specs, journal=j)
    print("COMPLETE", j.reused, j.ran)
""")


def test_sigterm_interrupt_then_resume_serving(tmp_path):
    """SIGTERM a serving sweep mid-flight; the resumed sweep replays the
    journaled serving cells (reconstructed as ServingCellResults) and runs
    only the rest."""
    path = str(tmp_path / "serving.jsonl")
    env = dict(os.environ, PYTHONPATH="src")
    repo = REPO
    proc = subprocess.Popen(
        [sys.executable, "-c", _SERVING_SWEEP_SCRIPT, path],
        env=env, cwd=repo)
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        if proc.poll() is not None:
            pytest.fail("serving sweep finished before it could be "
                        "interrupted")
        if os.path.exists(path) and sum(1 for _ in open(path)) >= 2:
            break
        time.sleep(0.05)
    proc.send_signal(signal.SIGTERM)
    proc.wait(timeout=60)
    assert proc.returncode != 0
    done_before = [tuple(json.loads(l)["key"]) for l in open(path)
                   if l.endswith("\n")]
    assert done_before
    specs = serving_specs(("poisson", "diurnal"), ("p9-volta-nvlink",),
                          ("kv_150", "kv_200"),
                          variants=("um", "um_advise", "um_prefetch",
                                    "um_both"))
    with SweepJournal(path, resume=True) as j:
        res = run_serving_specs(specs, journal=j)
        assert j.reused == len(done_before)     # journaled cells NOT re-run
        assert j.ran == len(specs) - len(done_before)
    assert len(res) == len(specs)
    assert all(c.report is not None and c.error is None for c in res)


# ---------------------------------------------------------------------------
# the paper's serving sweep against the reference engine
# ---------------------------------------------------------------------------

def _sweep_specs():
    return serving_specs(SWEEP_PATTERNS, SWEEP_PLATFORMS, tuple(SERVING_REGIMES))


# a fixed rotation over the 216 clean cells: stride 7 is coprime with the 12
# variants and with 216, so 36 steps visit 36 distinct cells and every
# variant, pattern, platform and regime
SAMPLE = [_sweep_specs()[(7 * k) % 216] for k in range(36)]
FAULT_SAMPLE = [("um", "kv_150"), ("um_advise", "kv_200"),
                ("um_hybrid_counters", "kv_150"), ("um_pinned_zero_copy", "kv_200")]


def test_sample_covers_the_sweep_axes():
    assert len(_sweep_specs()) == 216 and len(set(SAMPLE)) == 36
    assert {s[0] for s in SAMPLE} == {f"serve_{p}" for p in SWEEP_PATTERNS}
    assert {s[1] for s in SAMPLE} == set(SWEEP_PLATFORMS)
    assert {s[2] for s in SAMPLE} == set(strategy_names())
    assert {s[3] for s in SAMPLE} == set(SERVING_REGIMES)


@pytest.mark.parametrize("spec", SAMPLE, ids=lambda s: ":".join(s[:4]))
def test_sweep_sample_equals_reference(spec):
    app, pname, variant, regime, _ = spec
    got = run_serving_cell(app, variant, pname, regime)
    want = r_srv.run_serving_cell(app, variant, pname, regime)
    assert_same_cell(got, want)
    assert got.error is None
    p = PLATFORMS[pname]
    if variant in ("svm_remote", "um_hybrid_counters") and not (
            p.host_can_access_device and p.device_can_access_host):
        assert got.report is None           # N/A at the platform gate
    elif variant != "explicit":             # explicit may be N/A oversubscribed
        assert got.report is not None


@pytest.mark.parametrize("variant,regime", FAULT_SAMPLE)
def test_degraded_link_diurnal_equals_reference(variant, regime):
    got = run_serving_cell("diurnal", variant, "p9-volta-nvlink", regime,
                           faults="degraded_link")
    want = r_srv.run_serving_cell("diurnal", variant, "p9-volta-nvlink", regime,
                                  faults="degraded_link")
    assert_same_cell(got, want)
    assert got.faults == "degraded_link" and got.report is not None
    assert got.row()["fault_scenario"] == "degraded_link"


@pytest.mark.parametrize("variant", ("um", "um_both", "um_prefetch_adaptive",
                                     "um_hybrid_counters", "explicit"))
def test_bounds_runner_equals_reference(variant):
    """``bounds=True`` records the op stream in-cell and checks the report
    against its static bounds: the same report (the recorded run is
    bit-identical) and no violation, as in the reference."""
    got = run_serving_cell("poisson_short", variant, "p9-volta-nvlink", "kv_150",
                           bounds=True)
    plain = run_serving_cell("poisson_short", variant, "p9-volta-nvlink", "kv_150")
    want = r_srv.run_serving_cell("poisson_short", variant, "p9-volta-nvlink",
                                  "kv_150", bounds=True)
    assert_same_cell(got, want)
    assert_same_cell(got, plain)
    assert got.error_kind is None


def test_bounds_runner_through_the_pool():
    specs = serving_specs(("poisson_short",), ("intel-volta-pcie",), ("kv_200",),
                          variants=("um", "um_advise", "svm_remote"))
    got = run_serving_specs(specs, workers=2, bounds=True)
    want = r_srv.run_serving_specs(specs, bounds=True)
    for g, w in zip(got, want):
        assert_same_cell(g, w)


@pytest.mark.parametrize("spec", SAMPLE[:12] + [
    ("serve_diurnal", "p9-volta-nvlink", "um", "kv_150", "group", "degraded_link"),
    ("serve_poisson_short", "h100-host", "um", "kv_100", "group"),
], ids=lambda s: ":".join(str(x) for x in s))
def test_serving_spec_fingerprint_equals_reference(spec):
    """The same spec hashes to the same input fingerprint in both packages
    (the trace, the scheduler config, the KV fraction, the strategy), on
    every platform: the platform enters by name only."""
    assert p_cache.serving_spec_fingerprint(spec) == r_cache.serving_spec_fingerprint(spec)


def test_serving_cell_cache_hits_equal_fresh(tmp_path):
    specs = serving_specs(("poisson_short",), ("p9-volta-nvlink",), ("kv_150",),
                          variants=("um", "um_prefetch", "explicit"))
    c1 = p_cache.CellCache(tmp_path)
    fresh = run_serving_specs(specs, cache=c1)
    assert c1.stats()["hits"] == 0
    c2 = p_cache.CellCache(tmp_path)
    warm = run_serving_specs(specs, cache=c2)
    assert c2.stats() == {"hits": len(specs), "misses": {}}
    for g, w in zip(warm, fresh):
        assert type(g).__name__ == "ServingCellResult"
        assert_same_cell(g, w)


def test_h100_host_serving_gates():
    """The port's own host-attach platform: N/A exactly at the gates
    (coherent-fabric tiers; explicit serves kv_150 whole on 80 GB)."""
    cells = [run_serving_cell("poisson_short", v, "h100-host", "kv_150")
             for v in strategy_names()]
    assert not [c for c in cells if c.error]
    na = {c.variant for c in cells if c.report is None}
    assert na == {"svm_remote", "um_hybrid_counters"}
    assert all(c.report.completed == c.report.n_requests
               for c in cells if c.report is not None)
