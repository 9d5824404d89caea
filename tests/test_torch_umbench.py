"""The port's sweep engine (``repro_torch.umbench``: workload, variants,
schedule, platforms, harness, cellcache, journal, analysis) and examples
against the JAX package's, which import no JAX either.

Cells are compared over ``dataclasses.asdict(report)``: counters int-equal,
times within 1e-9 relative, N/A (no report) in the same cells.  The
reference's own host-attach platform has no counterpart in the port's
``PLATFORMS`` (``h100-host`` takes its place); its cells are compared on a
port ``SimPlatform`` built from the reference's fields inside the test.
"""
import ast
import contextlib
import dataclasses
import io
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro.core import faults as r_faults  # noqa: E402
from repro.core.residency import HBM_PER_DEVICE_BYTES  # noqa: E402
from repro.umbench import cellcache as r_cache  # noqa: E402
from repro.umbench import harness as rh  # noqa: E402
from repro.umbench import platforms as r_plat  # noqa: E402
from repro.umbench import variants as r_var  # noqa: E402
from repro_torch.core import faults as p_faults  # noqa: E402
from repro_torch.core.simulator import GB, SimPlatform  # noqa: E402
from repro_torch.umbench import cellcache as p_cache  # noqa: E402
from repro_torch.umbench import harness as ph  # noqa: E402
from repro_torch.umbench import platforms as p_plat  # noqa: E402
from repro_torch.umbench import variants as p_var  # noqa: E402
from repro_torch.umbench.journal import SweepJournal  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
REL = 1e-9
PAPER_PLATFORMS = ("intel-pascal-pcie", "intel-volta-pcie", "p9-volta-nvlink",
                   "grace-hopper-c2c")


def assert_same_cell(got, want):
    key = (want.app, want.platform, want.variant, want.regime, want.granularity,
           want.faults)
    assert (got.app, got.platform, got.variant, got.regime, got.granularity,
            got.faults) == key
    assert got.error == want.error and got.error_kind == want.error_kind, key
    assert (got.report is None) == (want.report is None), key
    if want.report is None:
        return
    g, w = dataclasses.asdict(got.report), dataclasses.asdict(want.report)
    assert g.keys() == w.keys(), key
    for k, wv in w.items():
        gv = g[k]
        if isinstance(wv, float):
            assert gv == wv or abs(gv - wv) <= REL * max(abs(gv), abs(wv)), (key, k, gv, wv)
        else:
            assert type(gv) is type(wv) and gv == wv, (key, k, gv, wv)


def assert_same_cells(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_same_cell(g, w)


# ---------------------------------------------------------------------------
# traces, registries, platforms
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("regime", sorted(rh.REGIMES))
@pytest.mark.parametrize("pname", PAPER_PLATFORMS)
@pytest.mark.parametrize("app", sorted(rh.WORKLOADS))
def test_workload_traces_equal(app, pname, regime):
    """Letter for letter: the cell cache fingerprints ``repr(workload)``."""
    total = rh.REGIMES[regime] * r_plat.PLATFORMS[pname].device_mem_gb * GB
    assert repr(ph.WORKLOADS[app](total)) == repr(rh.WORKLOADS[app](total))
    spec = (app, pname, "um_both", regime, "group")
    assert p_cache.spec_fingerprint(spec) == r_cache.spec_fingerprint(spec)


def test_registries_and_axes_equal():
    assert p_var.strategy_names() == r_var.strategy_names()
    for name in r_var.strategy_names():
        ps, rs = p_var.get_strategy(name), r_var.get_strategy(name)
        assert type(ps).__name__ == type(rs).__name__
        assert repr(sorted(vars(ps).items())) == repr(sorted(vars(rs).items()))
        assert dataclasses.asdict(ps.static_summary()) == \
            dataclasses.asdict(rs.static_summary())
    for axis in ("VARIANTS", "BEYOND_PAPER_VARIANTS", "EXTENDED_VARIANTS", "REGIMES",
                 "DEFAULT_PLATFORMS", "EXTENDED_PLATFORMS", "DEFAULT_REGIMES",
                 "EXTENDED_REGIMES"):
        assert getattr(ph, axis) == getattr(rh, axis), axis
    assert list(ph.WORKLOADS) == list(rh.WORKLOADS) and list(ph.APPS) == list(rh.APPS)
    assert [f.name for f in dataclasses.fields(ph.CellResult)] == \
        [f.name for f in dataclasses.fields(rh.CellResult)]


def test_platforms_equal_but_the_host_attach_point():
    assert tuple(p_plat.PLATFORMS) == PAPER_PLATFORMS + ("h100-host",)
    for name in PAPER_PLATFORMS:
        assert dataclasses.asdict(p_plat.PLATFORMS[name]) == \
            dataclasses.asdict(r_plat.PLATFORMS[name])
    h = p_plat.H100_HOST
    assert (h.name, h.device_mem_gb, h.device_bw_gbs, h.device_flops_tps,
            h.link_bw_gbs) == ("h100-host", 80.0, 3350.0, 67.0, 64.0)
    assert (h.fault_latency_us, h.host_can_access_device,
            h.device_can_access_host) == (0.0, False, True)
    assert not hasattr(p_plat, "TPU_V5E")
    for granularity in ("group", "page"):
        for name in PAPER_PLATFORMS:
            assert p_plat.working_set_chunks(p_plat.PLATFORMS[name], 1.5, granularity) == \
                r_plat.working_set_chunks(r_plat.PLATFORMS[name], 1.5, granularity)


# ---------------------------------------------------------------------------
# whole sweeps
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def extended():
    return ph.run_extended_matrix(), rh.run_extended_matrix()


@pytest.mark.parametrize("regime", rh.EXTENDED_REGIMES)
@pytest.mark.parametrize("pname", rh.EXTENDED_PLATFORMS)
def test_extended_matrix_equal(extended, pname, regime):
    got, want = extended
    assert len(got) == len(want) == 1152
    pick = [i for i, c in enumerate(want) if c.platform == pname and c.regime == regime]
    assert len(pick) == 96
    assert_same_cells([got[i] for i in pick], [want[i] for i in pick])
    assert all(got[i].error is None for i in pick)


def test_extended_matrix_na_cells(extended):
    """160 N/A cells, exactly where the gates put them: explicit under
    oversubscription, the coherent-fabric tiers off such fabrics."""
    got, _ = extended
    na = {(c.app, c.platform, c.variant, c.regime) for c in got if c.report is None}
    expect = set()
    for c in got:
        p = p_plat.PLATFORMS[c.platform]
        coherent = p.host_can_access_device and p.device_can_access_host
        if (c.variant == "explicit" and c.regime != "in_memory") or \
                (c.variant in ("svm_remote", "um_hybrid_counters") and not coherent):
            expect.add((c.app, c.platform, c.variant, c.regime))
    assert na == expect and len(na) == 160


def test_reference_host_shape_equal():
    """The reference's host-attach platform, as a port SimPlatform built
    from its fields: 8 apps x the extended variants and regimes."""
    port_p = SimPlatform(**dataclasses.asdict(r_plat.TPU_V5E))
    got = [ph.run_cell(a, v, port_p, r) for a in ph.WORKLOADS
           for v in ph.EXTENDED_VARIANTS for r in ph.EXTENDED_REGIMES]
    want = [rh.run_cell(a, v, r_plat.TPU_V5E, r) for a in rh.WORKLOADS
            for v in rh.EXTENDED_VARIANTS for r in rh.EXTENDED_REGIMES]
    assert len(got) == 288
    assert_same_cells(got, want)


def test_h100_host_cells_run():
    cells = [ph.run_cell(a, v, "h100-host", r) for a in ph.WORKLOADS
             for v in ph.EXTENDED_VARIANTS for r in ph.EXTENDED_REGIMES]
    assert len(cells) == 288 and not [c for c in cells if c.error]
    na = {(c.variant, c.regime) for c in cells if c.report is None}
    assert na == ({("explicit", "oversubscribed"), ("explicit", "oversubscribed_2x")}
                  | {(v, r) for v in ("svm_remote", "um_hybrid_counters")
                     for r in ph.EXTENDED_REGIMES})
    # fault_latency_us = 0: migration never stalls on a fault group
    assert all(c.report.fault_stall_s == 0.0 for c in cells if c.report is not None)


@pytest.mark.parametrize("regime", ("in_memory", "oversubscribed"))
@pytest.mark.parametrize("app", ("bs", "cg", "graph500", "fdtd3d"))
def test_page_granularity_sample_equal(app, regime):
    variants = ("um", "um_advise", "um_prefetch", "um_both", "um_prefetch_pipelined")
    got = [ph.run_cell(app, v, "intel-pascal-pcie", regime, "page") for v in variants]
    want = [rh.run_cell(app, v, "intel-pascal-pcie", regime, "page") for v in variants]
    assert_same_cells(got, want)


def _degradation_axes() -> dict:
    """The degradation sweep's axes, read from benchmarks/paper_tables.py."""
    names = ("DEGRADATION_APPS", "DEGRADATION_PLATS", "DEGRADATION_PAIRS",
             "DEGRADATION_SCENARIOS")
    tree = ast.parse((REPO / "benchmarks" / "paper_tables.py").read_text())
    axes = {node.targets[0].id: ast.literal_eval(node.value) for node in tree.body
            if isinstance(node, ast.Assign) and len(node.targets) == 1
            and getattr(node.targets[0], "id", None) in names}
    assert set(axes) == set(names)
    return axes


@pytest.mark.parametrize("scenario", _degradation_axes()["DEGRADATION_SCENARIOS"])
def test_fault_scenarios_equal(scenario):
    axes = _degradation_axes()
    specs = [(app, pname, variant, "oversubscribed", "group", scenario)
             for _, static, adaptive in axes["DEGRADATION_PAIRS"]
             for variant in (static, adaptive)
             for app in axes["DEGRADATION_APPS"]
             for pname in axes["DEGRADATION_PLATS"]]
    port_specs = [s[:5] + (p_faults.SCENARIOS[scenario],) for s in specs]
    ref_specs = [s[:5] + (r_faults.SCENARIOS[scenario],) for s in specs]
    got, want = ph.run_specs(port_specs), rh.run_specs(ref_specs)
    assert_same_cells(got, want)
    assert sum(c.report.n_retries + c.report.n_degraded_xfers + c.report.n_storm_faults
               for c in got if c.report is not None) > 0


# ---------------------------------------------------------------------------
# run_cell's analyses, failure records
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flag", ("lint", "audit", "bounds"))
def test_run_cell_analyses_equal(flag):
    for app in ("bs", "cg", "graph500"):
        for variant in ("explicit", "um_advise", "um_hybrid_counters",
                        "um_prefetch_adaptive"):
            for pname, regime in (("p9-volta-nvlink", "oversubscribed"),
                                  ("grace-hopper-c2c", "in_memory"),
                                  ("intel-pascal-pcie", "in_memory")):
                got = ph.run_cell(app, variant, pname, regime, **{flag: True})
                want = rh.run_cell(app, variant, pname, regime, **{flag: True})
                assert_same_cell(got, want)
                assert got.error is None


def test_lint_refusal_and_bounds_failure():
    from repro_torch.umbench.workload import WorkloadBuilder
    w = WorkloadBuilder("broken")
    w.alloc("a", 4 * 2**20)
    w.kernel("k", flops=1.0, reads=("a",), writes=("a",))
    w.free("a")
    w.free("a")                                            # UML003 double free
    cell = ph.run_cell(w.build(), "um", "intel-pascal-pcie", "in_memory", lint=True)
    assert cell.report is None and cell.error_kind == "lint" and "UML003" in cell.error
    good = ph.run_cell("bs", "um", "intel-pascal-pcie", "oversubscribed")
    assert ph.bounds_failure(good) is None
    tampered = dataclasses.replace(good, report=dataclasses.replace(
        good.report, n_faults=good.report.n_faults * 10 + 100))
    bad = ph.bounds_failure(tampered)
    assert bad.report is None and bad.error_kind == "bounds" and "n_faults" in bad.error
    ref = rh.bounds_failure(rh.run_cell("bs", "um", "intel-pascal-pcie", "oversubscribed"))
    assert ref is None


def test_failure_records_and_timeouts():
    with pytest.raises(KeyError):
        ph.run_cell("bs", "no_such_variant", "intel-pascal-pcie", "in_memory")
    slow = ph.run_cell("graph500", "um", "p9-volta-nvlink", "oversubscribed",
                       granularity="page", timeout_s=0.005)
    assert slow.report is None and slow.error == "timeout after 0.005s"
    ok = ph.run_cell("bs", "um", "intel-pascal-pcie", "in_memory", timeout_s=60.0)
    assert ok.error is None and "error" not in ok.row()
    assert ok.row() == rh.run_cell("bs", "um", "intel-pascal-pcie", "in_memory").row()


# ---------------------------------------------------------------------------
# journal, cell cache, the process pool
# ---------------------------------------------------------------------------

def test_journal_resume_reruns_nothing(tmp_path):
    specs = ph.matrix_specs(apps=["bs", "cg"], platform_names=("intel-volta-pcie",),
                            regimes=("in_memory", "oversubscribed"))
    path = str(tmp_path / "sweep.jsonl")
    with SweepJournal(path, resume=False) as j:
        first = ph.run_specs(specs[:7], journal=j)
    with open(path, "a") as f:
        f.write('{"key": ["torn"\n')                       # a line cut short
    with SweepJournal(path) as j:
        second = ph.run_specs(specs, journal=j)
        assert (j.reused, j.ran) == (7, len(specs) - 7)
    with SweepJournal(path) as j:
        third = ph.run_specs(specs, journal=j)
        assert (j.reused, j.ran) == (len(specs), 0)
    assert_same_cells(second[:7], first)
    assert_same_cells(third, second)
    assert_same_cells(second, rh.run_specs(specs))


def test_cell_cache_hits_equal_fresh_cells(tmp_path):
    specs = ph.matrix_specs(apps=["bs", "fdtd3d"], platform_names=("p9-volta-nvlink",),
                            regimes=("in_memory", "oversubscribed"))
    c1 = p_cache.CellCache(tmp_path)
    fresh = ph.run_specs(specs, cache=c1)
    assert c1.stats()["hits"] == 0
    c2 = p_cache.CellCache(tmp_path)
    warm = ph.run_specs(specs, cache=c2)
    assert c2.stats() == {"hits": len(specs), "misses": {}}
    assert_same_cells(warm, fresh)
    c3 = p_cache.CellCache(tmp_path, rev="another engine")
    ph.run_specs(specs[:3], cache=c3)
    assert c3.stats() == {"hits": 0, "misses": {p_cache.MISS_CODE_REV: 3}}
    assert p_cache.code_rev() != r_cache.code_rev()        # the port hashes its own
    assert_same_cells(fresh, rh.run_specs(specs))


def test_parallel_matrix_equals_serial():
    serial = ph.run_matrix()
    pooled = ph.run_matrix(workers=2)
    assert len(serial) == 240
    assert [c.row() for c in pooled] == [c.row() for c in serial]
    assert_same_cells(serial, rh.run_matrix())


# ---------------------------------------------------------------------------
# the paper's five findings (tests/test_paper_claims.py's thresholds)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def speedups():
    return ph.speedup_vs_um(ph.run_matrix())


def test_claim1_intel_oversubscribed_advise_wins(speedups):
    for plat in ("intel-pascal-pcie", "intel-volta-pcie"):
        s = speedups[("bs", plat, "oversubscribed", "um_advise", "group")]
        assert 1.10 <= s <= 1.6, s
        assert speedups[("conv1", plat, "oversubscribed", "um_advise", "group")] > 1.3


def test_claim2_p9_in_memory_advise_wins(speedups):
    assert speedups[("cg", "p9-volta-nvlink", "in_memory", "um_advise", "group")] > 1.3
    assert speedups[("fdtd3d", "p9-volta-nvlink", "in_memory", "um_advise", "group")] > 1.3


def test_claim3_p9_oversubscribed_advise_degrades(speedups):
    assert speedups[("bs", "p9-volta-nvlink", "oversubscribed", "um_advise", "group")] < 0.5
    assert speedups[("cg", "p9-volta-nvlink", "oversubscribed", "um_advise", "group")] < 0.5


def test_claim4_prefetch_platform_contrast(speedups):
    for app in ("bs", "cg", "fdtd3d"):
        intel = speedups[(app, "intel-volta-pcie", "in_memory", "um_prefetch", "group")]
        p9 = speedups[(app, "p9-volta-nvlink", "in_memory", "um_prefetch", "group")]
        assert intel > p9, (app, intel, p9)
    assert speedups[("cg", "intel-volta-pcie", "in_memory", "um_prefetch", "group")] > 1.5


def test_claim5_um_overhead_vs_explicit(speedups):
    assert speedups[("fdtd3d", "intel-pascal-pcie", "in_memory", "explicit", "group")] > 1.5
    assert speedups[("conv1", "intel-volta-pcie", "in_memory", "explicit", "group")] > 2.0
    assert ("bs", "intel-pascal-pcie", "oversubscribed", "explicit",
            "group") not in speedups


def test_speedups_equal_reference(speedups):
    want = rh.speedup_vs_um(rh.run_matrix())
    assert speedups.keys() == want.keys()
    for k, v in want.items():
        assert abs(speedups[k] - v) <= REL * v, k


# ---------------------------------------------------------------------------
# no JAX; the examples
# ---------------------------------------------------------------------------

def test_harness_runs_without_jax():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "from repro_torch.umbench.harness import run_matrix, run_cell, speedup_vs_um\n"
        "from repro_torch.umbench import cellcache, journal, analysis\n"
        "res = run_matrix(apps=['bs'], platform_names=('intel-pascal-pcie',),\n"
        "                 regimes=('in_memory',))\n"
        "assert len(res) == 5 and all(r.report is not None or\n"
        "                             r.variant == 'explicit' for r in res)\n"
        "c = run_cell('cg', 'um_both', 'h100-host', 'oversubscribed', lint=True,\n"
        "             audit=True, bounds=True)\n"
        "assert c.error is None and c.report is not None\n"
        "loaded = [m for m in sys.modules if m == 'repro' or m.startswith('repro.')]\n"
        "assert not loaded, loaded\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def _reference_example(name: str) -> list[str]:
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, os.path.join("examples", name)], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc.stdout.splitlines()


def _port_example(main, argv) -> tuple[list[str], object]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = main(argv)
    return buf.getvalue().splitlines(), result


def _section(lines: list[str], number: int) -> list[str]:
    """The lines of section ``number`` of an example, its banner cut."""
    start = next(i for i, ln in enumerate(lines) if ln.startswith(f"{number}. "))
    end = next((i for i in range(start + 2, len(lines))
                if lines[i].startswith(f"{number + 1}. ")), len(lines))
    return [ln for ln in lines[start + 2:end] if ln and set(ln) != {"="}]


def test_quickstart_matches_reference():
    from repro_torch.examples import quickstart
    want = _reference_example("quickstart.py")
    got, res = _port_example(quickstart.main, ["--device", "cpu", "--hbm-bytes",
                                               str(HBM_PER_DEVICE_BYTES)])
    assert _section(got, 1) == _section(want, 1)
    assert _section(got, 2) == _section(want, 2)
    bs = res["bs"]
    from repro_torch.kernels.black_scholes.ref import black_scholes_ref
    call, put = black_scholes_ref(bs["s"], bs["x"], bs["t"], 0.02, 0.30)
    assert (bs["call"] - call).abs().max() <= 1e-4
    assert (bs["put"] - put).abs().max() <= 1e-4
    assert bs["s"].device.type == "cpu" and len(_section(got, 3)) == 3


def test_um_advise_tour_matches_reference():
    from repro_torch.examples import um_advise_tour
    got, res = _port_example(um_advise_tour.main, [])
    assert got == _reference_example("um_advise_tour.py")
    assert len(res["speedups"]) == 8 and len(res["tiers"]) == 5


def test_oversubscribe_demo_section4_matches_reference():
    from repro_torch.examples import oversubscribe_demo
    want = _reference_example("oversubscribe_demo.py")
    got, _ = _port_example(oversubscribe_demo.main, ["--device", "cpu", "--hbm-bytes",
                                                     str(HBM_PER_DEVICE_BYTES)])
    assert _section(got, 4) == _section(want, 4) and len(_section(got, 4)) == 2
    assert _section(got, 2) == _section(want, 2)
