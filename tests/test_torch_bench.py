"""The port's benchmark runner and tables (``repro_torch.bench.run``,
``bench.paper_tables``, ``bench.lm_bench.arch_step_rows``) and its serving
demo, against the JAX package's ``benchmarks/`` and ``examples/`` on the
same inputs.

The table functions read module-level memos (``_MATRIX``, ``_EXTENDED``,
...): every test here sets them through ``monkeypatch`` (the module
fixture through its own ``MonkeyPatch`` context), so no sweep leaks into
another test of the same worker.
"""
import contextlib
import copy
import dataclasses
import hashlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from benchmarks import paper_tables as rpt
from benchmarks import run as r_run
from repro.umbench import harness as rh
from repro.umbench.serving import run_serving_cell as r_serving_cell
from repro_torch.bench import lm_bench
from repro_torch.bench import paper_tables as pt
from repro_torch.bench import run
from repro_torch.umbench import harness as ph
from repro_torch.umbench.serving import run_serving_cell

REPO = Path(__file__).resolve().parent.parent
ARTIFACT = REPO / "BENCH_umbench.json"
MEMOS = ("_MATRIX", "_EXTENDED", "_PAGE", "_DEGRADATION", "_SERVING", "_SERVING_FAULTS")


def _isolate(mp, mod):
    """Fresh memos and bookkeeping for ``mod`` under the patcher ``mp``."""
    for name in MEMOS:
        mp.setattr(mod, name, None)
    for name, value in (("SWEEP_WORKERS_USED", {}), ("JOURNAL_STATS", {}),
                        ("CACHE_STATS", {}), ("CACHE_HIT_KEYS", set()),
                        ("BOUNDS_STATS", {}), ("SWEEP_JOURNAL_DIR", None),
                        ("SWEEP_RESUME", False), ("SWEEP_CACHE_DIR", None),
                        ("LAST_SWEEP_WORKERS", None)):
        mp.setattr(mod, name, value)


def artifact_sha() -> str:
    return hashlib.sha256(ARTIFACT.read_bytes()).hexdigest()


# ---------------------------------------------------------------------------
# _cell_key / cell_deltas
# ---------------------------------------------------------------------------

def _row(**kw):
    base = {"app": "bs", "platform": "p", "variant": "um",
            "regime": "in_memory", "granularity": "group", "total_s": 1.0}
    base.update(kw)
    return base


def _delta_cases():
    cells = json.loads(ARTIFACT.read_text())["cells"]
    real = cells[::7]
    shifted = copy.deepcopy(real)
    for i, r in enumerate(shifted):
        if r.get("total_s") is not None and i % 3 == 0:
            r["total_s"] = round(r["total_s"] * (1 + 0.01 * (i % 11 - 5)), 4)
        if i % 17 == 0:
            r["error"] = "timeout after 0.005s"
            r["error_kind"] = "audit" if i % 2 else None
    cached = {tuple(r[f] for f in run._KEY_FIELDS) for r in shifted[::5]}
    return {
        "pre_schema": ([{"app": "bs", "platform": "p", "total_s": 9.0}, "garbage-entry",
                        _row(variant="um_both", app=["bs"]), _row(variant="um", total_s=2.0)],
                       [_row(variant="um", total_s=2.0), _row(variant="um_advise")], ()),
        "all_malformed": ([{"bogus": 1}, 42], [_row()], ()),
        "new_axes": ([_row(variant="um", total_s=2.0), _row(variant="um_advise")],
                     [_row(variant="um", total_s=2.0), _row(variant="um_advise"),
                      _row(variant="um_hybrid_counters", total_s=99.0),
                      _row(variant="um", granularity="page", total_s=97.0)], ()),
        "errors_both_sides": ([_row(error="boom"), _row(variant="x", total_s=3.0)],
                              [_row(total_s=None, error="timeout", error_kind="bounds"),
                               _row(variant="x", total_s=None)], ()),
        "artifact_shifted": (real, shifted, ()),
        "artifact_shifted_cached": (real, shifted, cached),
        "artifact_unchanged": (real, real, ()),
        "artifact_shrunk": (real, real[: len(real) // 2], ()),
    }


@pytest.mark.parametrize("case", sorted(_delta_cases()))
def test_cell_deltas_equal_reference(case):
    prev, cur, cached = _delta_cases()[case]
    got = run.cell_deltas(prev, cur, cached_keys=cached)
    assert got == r_run.cell_deltas(prev, cur, cached_keys=cached)
    assert json.loads(json.dumps(got)) == got
    if case == "artifact_shifted":
        assert got["cells_changed"] > 0 and got["cells_error"] > 0
    if case == "artifact_shifted_cached":
        assert got["cells_changed"] < run.cell_deltas(prev, cur)["cells_changed"]


def test_cell_key_equals_reference():
    rows = [{"app": "bs"}, "not a dict", None, 42, _row(app=["bs"]),
            {"app": "bs", "platform": "p", "variant": "um", "regime": "in_memory"},
            _row(granularity="page"), _row(error="x")]
    rows += json.loads(ARTIFACT.read_text())["cells"][::50]
    for r in rows:
        assert run._cell_key(r) == r_run._cell_key(r), r
    assert run._KEY_FIELDS == r_run._KEY_FIELDS
    assert run._KEY_DEFAULTS == r_run._KEY_DEFAULTS


# ---------------------------------------------------------------------------
# the tables' CSV lines
# ---------------------------------------------------------------------------

TABLES = {
    "claims": "table_claims_summary", "table1": "table_working_sets",
    "fig3": "table_fig3_in_memory", "fig6": "table_fig6_oversubscribed",
    "fig4_7": "table_fig4_7_breakdowns", "psched": "table_prefetch_pipeline",
    "ext": "table_extended_sweep", "degradation": "table_degradation",
    "boundstight": "table_bounds_tightness",
}


@pytest.fixture(scope="module")
def tables():
    """Both packages' tables over their own sweeps (run serially, the
    extended matrix with the in-sweep bounds gate); memos restored after."""
    with pytest.MonkeyPatch.context() as mp:
        out = {}
        for key, mod in (("port", pt), ("ref", rpt)):
            _isolate(mp, mod)
            mod.matrix_cells(extended=True, workers=1)
            mod.degradation_cells(workers=1)
            out[key] = {name: getattr(mod, fn)() for name, fn in TABLES.items()}
            out[key]["_bounds"] = copy.deepcopy(mod.BOUNDS_STATS)
            out[key]["_workers"] = dict(mod.SWEEP_WORKERS_USED)
        yield out


@pytest.mark.parametrize("name", sorted(TABLES))
def test_table_csv_equals_reference(tables, name):
    got, want = tables["port"][name], tables["ref"][name]
    assert len(got) > 1 and got[0].startswith("table,")
    assert got == want


def test_claims_met_and_bookkeeping(tables):
    claims = tables["port"]["claims"][1:]
    assert len(claims) == 5
    assert tables["port"]["_bounds"] == tables["ref"]["_bounds"]
    assert tables["port"]["_bounds"]["ext"]["violations"] == 0
    assert tables["port"]["_bounds"]["ext"]["checked"] > 900
    assert tables["port"]["_workers"] == {"ext": 1, "degradation": 1}
    worst = [r for r in tables["port"]["degradation"] if r.startswith("degradation_worst")]
    assert sum(r.endswith(",yes") for r in worst) >= 3


def _page_cells(harness):
    return [harness.run_cell(app, v, "intel-pascal-pcie", regime, "page")
            for app in ("bs", "cg") for v in ("um", "um_advise", "explicit")
            for regime in ("in_memory", "oversubscribed")]


def test_page_and_pagegate_formatting(monkeypatch):
    """``page`` and ``pagegate`` over a small page-granularity cell list in
    both packages, with a bounds violation planted in one cell."""
    lines = {}
    for key, mod, harness in (("port", pt, ph), ("ref", rpt, rh)):
        _isolate(monkeypatch, mod)
        page = _page_cells(harness)
        group = [harness.run_cell(c.app, c.variant, c.platform, c.regime) for c in page]
        monkeypatch.setattr(mod, "_PAGE", page)
        monkeypatch.setattr(mod, "_EXTENDED", group)
        good = mod.table_page_bounds_gate()
        i = next(i for i, c in enumerate(page) if c.report is not None)
        import dataclasses
        page[i] = dataclasses.replace(page[i], report=dataclasses.replace(
            page[i].report, n_faults=page[i].report.n_faults * 10 + 100))
        mod.BOUNDS_STATS.pop("page")
        bad = mod.table_page_bounds_gate()
        lines[key] = (mod.table_page_granularity(), good, bad, page[i].error_kind)
    assert lines["port"] == lines["ref"]
    page, good, bad, kind = lines["port"]
    assert len(page) == 13 and any(",NA," in r for r in page)
    # 12 cells, 2 of them N/A (explicit oversubscribed): 10 checked
    assert good[1] == "pagegate,page,12,10,0" and bad[1] == "pagegate,page,12,10,1"
    assert kind == "bounds"


def test_serving_formatting(monkeypatch):
    """``serving`` over a small clean list and its fault-composed twins,
    N/A and the goodput ratio included."""
    clean_args = [("poisson_short", v, "p9-volta-nvlink", r)
                  for v in ("um", "explicit", "um_hybrid_counters") for r in ("kv_150", "kv_200")]
    clean_args += [("poisson_short", "svm_remote", "intel-volta-pcie", "kv_150")]
    lines = {}
    for key, mod, cell in (("port", pt, run_serving_cell), ("ref", rpt, r_serving_cell)):
        _isolate(monkeypatch, mod)
        monkeypatch.setattr(mod, "_SERVING", [cell(*a) for a in clean_args])
        monkeypatch.setattr(mod, "_SERVING_FAULTS", [
            cell(*a, faults="degraded_link") for a in clean_args[:4]])
        lines[key] = mod.table_serving()
    assert lines["port"] == lines["ref"]
    rows = lines["port"]
    assert len(rows) == 1 + 7 + 4
    assert sum(",degraded_link," in r for r in rows) == 4
    assert any(r.endswith(",NA") and ",clean," in r for r in rows)
    assert any(",degraded_link," in r and not r.endswith(",NA") for r in rows)
    assert "serving,poisson_short,intel-volta-pcie,kv_150,svm_remote,clean," \
        + ",".join(["NA"] * 12) in rows


def test_serving_cells_axes_equal_reference():
    for name in ("SERVING_PATTERNS", "SERVING_PLATFORMS", "SERVING_FAULT_SCENARIO",
                 "SERVING_FAULT_PATTERN", "APPS", "PLATS", "VARIANTS",
                 "DEGRADATION_APPS", "DEGRADATION_PLATS", "DEGRADATION_PAIRS",
                 "DEGRADATION_SCENARIOS"):
        assert getattr(pt, name) == getattr(rpt, name), name


# ---------------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------------

def _main(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run.main(argv)
    return rc, buf.getvalue().splitlines()


def test_fast_json_writes_out_and_not_the_reference_artifact(tmp_path, monkeypatch):
    _isolate(monkeypatch, pt)
    monkeypatch.chdir(tmp_path)
    before = artifact_sha()
    out = tmp_path / "bench"
    out.mkdir()
    rc, lines = _main(["--fast", "--json", "--out", str(out)])
    assert rc == 0
    assert artifact_sha() == before
    assert not (tmp_path / "BENCH_umbench.json").exists()
    assert not (tmp_path / run.BENCH_PATH).exists()
    written = out / run.BENCH_PATH
    payload = json.loads(written.read_text())
    assert sorted(p.name for p in out.iterdir()) == [run.BENCH_PATH]  # journal removed
    assert payload["n_cells"] == len(payload["cells"]) == 240
    assert "speedup_vs_seed" not in payload and "seed_baseline_240_wall_s" not in payload
    assert payload["host"]["cpu_count"] == os.cpu_count()
    assert set(payload["block_wall_s"]) >= {"matrix_240", "claims", "fig3", "roofline"}
    claims = [ln for ln in lines if ln.startswith("claims,")]
    assert len(claims) == 5
    assert lines[-1].startswith(f"wrote {written} (240 cells")
    # every cell equals the committed reference artifact's row
    committed = {run._cell_key(r): r for r in json.loads(ARTIFACT.read_text())["cells"]}
    for row in payload["cells"]:
        assert row == committed[run._cell_key(row)], row
    # a second run diffs against the first: nothing changed
    monkeypatch.setattr(pt, "_MATRIX", None)
    rc, lines = _main(["--fast", "--json", "--out", str(written)])
    again = json.loads(written.read_text())
    assert again["vs_prev"]["cells_compared"] == 240
    assert again["vs_prev"]["cells_changed"] == 0
    assert artifact_sha() == before


def test_fast_tables_equal_reference_main(tmp_path, monkeypatch):
    """The CSV blocks of ``--fast`` (no ``--json``) equal ``python -m
    benchmarks.run --fast``'s, but for the roofline and dry-run blocks,
    which read each package's own dry-run records."""
    _isolate(monkeypatch, pt)
    _isolate(monkeypatch, rpt)
    rc, got = _main(["--fast", "--out", str(tmp_path)])
    assert rc == 0
    # the reference's runner journals into (and then removes) a directory
    # of its working directory: give it the test's own
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", ["run", "--fast"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        r_run.main()
    want = buf.getvalue().splitlines()

    def sim_blocks(lines):
        return [ln for ln in lines
                if ln.split(",")[0] in ("claims", "table1", "fig3", "fig6", "fig4_7")]
    assert sim_blocks(got) and sim_blocks(got) == sim_blocks(want)


def test_resume_replays_a_journal(tmp_path, monkeypatch):
    """``--resume`` reaches the sweeps; a journaled sweep cut short and
    resumed replays its completed cells and runs only the rest, to the
    same results."""
    _isolate(monkeypatch, pt)
    rc, _ = _main(["--fast", "--resume", "--out", str(tmp_path)])
    assert rc == 0
    assert pt.SWEEP_RESUME is True
    assert pt.SWEEP_JOURNAL_DIR == str(tmp_path / run.JOURNAL_DIR)

    jdir = tmp_path / "journals"
    pt.configure_journals(str(jdir), resume=False)
    monkeypatch.setattr(pt, "_DEGRADATION", None)
    first = pt.degradation_cells(workers=1)
    assert pt.JOURNAL_STATS["degradation"] == (0, len(first)) and len(first) == 96
    path = jdir / "degradation.jsonl"
    lines = path.read_text().splitlines(keepends=True)
    path.write_text("".join(lines[:40]) + lines[40][: len(lines[40]) // 2])
    pt.configure_journals(str(jdir), resume=True)
    monkeypatch.setattr(pt, "_DEGRADATION", None)
    second = pt.degradation_cells(workers=1)
    assert pt.JOURNAL_STATS["degradation"] == (40, 56)
    assert [c.row() for c in second] == [c.row() for c in first]


def test_serving_cells_journal_and_cache(tmp_path, monkeypatch):
    """``serving_fault_cells`` through the journal and the cell cache with
    a small variant list: a second run is all cache hits, equal rows."""
    import repro_torch.umbench.serving as srv
    specs_fn = srv.serving_specs

    def few(*a, **kw):
        return specs_fn(*a, **dict(kw, variants=("um", "um_advise")))
    monkeypatch.setattr(srv, "serving_specs", few)
    _isolate(monkeypatch, pt)
    pt.configure_journals(str(tmp_path / "j"), resume=False)
    pt.configure_cache(str(tmp_path / "c"))
    first = pt.serving_fault_cells(workers=1)
    assert len(first) == 4 and pt.CACHE_STATS["serving_faults"]["hits"] == 0
    monkeypatch.setattr(pt, "_SERVING_FAULTS", None)
    second = pt.serving_fault_cells(workers=1)
    assert pt.CACHE_STATS["serving_faults"] == {"hits": 4, "misses": {}}
    assert [c.row() for c in second] == [c.row() for c in first]
    assert all(type(c).__name__ == "ServingCellResult" for c in second)
    assert all(c.faults == "degraded_link" for c in second)


# ---------------------------------------------------------------------------
# arch_step_rows, the demo
# ---------------------------------------------------------------------------

def test_arch_step_rows_format():
    rows = lm_bench.arch_step_rows(archs=("qwen2-7b", "musicgen-medium"), device="cpu")
    assert rows[0] == "table,arch,op,us_per_call,derived"
    assert len(rows) == 5
    for row, (arch, op) in zip(rows[1:], (("qwen2-7b", "train_step"),
                                          ("qwen2-7b", "decode_step"),
                                          ("musicgen-medium", "train_step"),
                                          ("musicgen-medium", "decode_step"))):
        table, a, o, us, derived = row.split(",")
        assert (table, a, o) == ("lm", arch, op)
        assert int(us) > 0
        assert derived == ("reduced B2xS64" if op == "train_step" else "reduced B2")


def test_kv_serving_demo_matches_reference():
    from repro_torch.examples import kv_serving_demo
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        reports = kv_serving_demo.main([])
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, os.path.join("examples", "kv_serving_demo.py")],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert buf.getvalue() == proc.stdout
    assert set(reports) == {"kv_100", "kv_200"}
    assert all(len(r) == 4 for r in reports.values())


# ---------------------------------------------------------------------------
# the port's rules over these modules
# ---------------------------------------------------------------------------

def test_every_reference_module_has_a_counterpart():
    """The port covers every module of the JAX package: each ``.py`` file
    under src/repro has one at the same path under src/repro_torch."""
    ref = REPO / "src" / "repro"
    port = REPO / "src" / "repro_torch"
    missing = [str(f.relative_to(ref)) for f in sorted(ref.rglob("*.py"))
               if "__pycache__" not in f.parts and not (port / f.relative_to(ref)).exists()]
    assert not missing, missing


def test_new_modules_run_with_jax_blocked(tmp_path):
    """With JAX made unimportable, the serving sweep, the analyses, the seed
    oracle, the runner and the demo import and run on the CPU, and nothing
    of the JAX package gets loaded."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch.core.seed_simulator\n"
        "from repro_torch.bench import lm_bench, paper_tables, run\n"
        "from repro_torch.umbench import serving\n"
        "from repro_torch.umbench.analysis import contracts, trace, __main__\n"
        "from repro_torch.examples import kv_serving_demo\n"
        "cell = serving.run_serving_cell('poisson_short', 'um', 'h100-host', 'kv_150',\n"
        "                                bounds=True)\n"
        "assert cell.error is None and cell.report.completed == 12, cell\n"
        "assert __main__.main(['--contracts']) == 0\n"
        "assert run.main(['--fast', '--json', '--out', sys.argv[1]]) == 0\n"
        "rows = lm_bench.arch_step_rows(archs=('rwkv6-3b',), device='cpu')\n"
        "assert len(rows) == 3, rows\n"
        "loaded = [m for m in sys.modules if m == 'repro' or m.startswith('repro.')]\n"
        "assert not loaded, loaded\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path)], env=env,
                          cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == "ok"
    assert (tmp_path / run.BENCH_PATH).exists()
