"""The port's strategy contracts, recording proxy and analysis CLI
(``repro_torch.umbench.analysis``: ``contracts``, ``trace``, ``__main__``)
against the JAX package's, which import no JAX either.

Every test of tests/test_analysis_contracts.py runs on the port.  The
recording proxy must leave a run bit-identical to an unrecorded one, and
its op streams must equal the reference's.  The CLI's exit code and its
printed findings for each flag must equal ``python -m
repro.umbench.analysis`` on the same flags, and the exit codes 0/1/2 must
split clean runs, errors and strict-armed warnings as the reference's do.
"""
import contextlib
import copy
import dataclasses
import io
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro.core.simulator import UMSimulator as RUMSimulator
from repro.umbench import harness as rh
from repro.umbench import platforms as r_plat
from repro.umbench import variants as r_var
from repro.umbench.analysis import __main__ as r_cli
from repro.umbench.analysis import contracts as r_contracts
from repro.umbench.analysis import trace as r_trace
from repro_torch.core.simulator import UMSimulator
from repro_torch.umbench import harness
from repro_torch.umbench import platforms as plat
from repro_torch.umbench import variants as var
from repro_torch.umbench.analysis import (
    CONTRACT_RULES,
    EXPECTED_GATES,
    RULES,
    SANCTIONED_HOOK_OPS,
    Finding,
    RecordingSim,
    check_contracts,
    lint_ops,
    record_serving_ops,
    to_lint_ops,
)
from repro_torch.umbench.analysis import __main__ as cli
from repro_torch.umbench.analysis import contracts
from repro_torch.umbench.serving import run_serving_cell
from repro_torch.umbench.serving.scheduler import ServingConfig, serve
from repro_torch.umbench.serving.traffic import get_pattern

REPO = Path(__file__).resolve().parent.parent


def rule_ids(findings):
    return {f.rule_id for f in findings}


def finding_tuples(findings):
    return [(f.rule_id, f.severity, f.step_idx, f.region, f.message) for f in findings]


@pytest.fixture
def temp_strategy():
    """Register a strategy for one test and guarantee de-registration (the
    registry is process-global)."""
    registered = []

    def _register(strategy):
        var.register(strategy, replace=True)
        registered.append(strategy.name)
        return strategy

    yield _register
    for name in registered:
        var._REGISTRY.pop(name, None)


# ---------------------------------------------------------------------------
# tests/test_analysis_contracts.py on the port
# ---------------------------------------------------------------------------

def test_whole_registry_passes_both_contracts():
    findings = check_contracts()
    assert findings == [], [str(f) for f in findings]
    assert finding_tuples(findings) == finding_tuples(r_contracts.check_contracts())


def test_gate_table_is_total_over_registry():
    assert set(EXPECTED_GATES) == set(var.strategy_names())


def test_tables_equal_reference():
    assert CONTRACT_RULES == r_contracts.CONTRACT_RULES
    assert EXPECTED_GATES == r_contracts.EXPECTED_GATES
    assert SANCTIONED_HOOK_OPS == r_contracts.SANCTIONED_HOOK_OPS
    assert set(contracts.GATE_PREDICATES) == set(r_contracts.GATE_PREDICATES)
    assert dataclasses.asdict(contracts.PROBE_PLATFORM) == \
        dataclasses.asdict(r_contracts.PROBE_PLATFORM)
    assert repr(contracts.probe_workload()) == repr(r_contracts.probe_workload())
    assert [dataclasses.astuple(r) for r in contracts._probe_requests()] == \
        [dataclasses.astuple(r) for r in r_contracts._probe_requests()]
    assert r_trace.RECORDED == __import__(
        "repro_torch.umbench.analysis.trace", fromlist=["RECORDED"]).RECORDED


def test_gates_on_every_platform_equal_reference():
    """The gate predicates against each platform's flags; the port's
    ``h100-host`` (no host access to the card, the card reads the host)
    gates the coherent tiers off and keeps zero-copy on."""
    for name in r_plat.PLATFORMS.keys() & plat.PLATFORMS.keys():
        for gate, pred in contracts.GATE_PREDICATES.items():
            assert pred(plat.PLATFORMS[name]) == \
                r_contracts.GATE_PREDICATES[gate](r_plat.PLATFORMS[name])
    h = plat.PLATFORMS["h100-host"]
    got = {g: p(h) for g, p in contracts.GATE_PREDICATES.items()}
    assert got == {"all": True, "coherent_fabric": False, "zero_copy": True}


def test_umc101_gate_mismatch(monkeypatch):
    monkeypatch.setitem(contracts.EXPECTED_GATES, "um", "coherent_fabric")
    findings = check_contracts(["um"], hooks=False)
    assert rule_ids(findings) == {"UMC101"}
    wrong = findings[0].message
    assert "intel-pascal-pcie" in wrong
    assert "h100-host" in wrong            # the port's own platform is checked too
    monkeypatch.setitem(r_contracts.EXPECTED_GATES, "um", "coherent_fabric")
    want = r_contracts.check_contracts(["um"], hooks=False)
    assert rule_ids(want) == {"UMC101"}
    assert wrong.replace("h100-host", "tpu-v5e-host") == want[0].message


def test_umc102_undocumented_strategy(temp_strategy):
    class Undocumented(var.UMStrategy):
        name = "undocumented_probe"

    temp_strategy(Undocumented())
    findings = check_contracts(["undocumented_probe"], hooks=False)
    assert rule_ids(findings) == {"UMC102"}


def test_umc104_stale_gate_table_entry(monkeypatch):
    monkeypatch.setitem(contracts.EXPECTED_GATES, "ghost_tier", "all")
    findings = check_contracts(["um"], hooks=False)
    assert rule_ids(findings) == {"UMC104"}
    assert findings[0].region == "ghost_tier"


def test_umc103_corrupting_before_step(temp_strategy):
    class CorruptHook(var.UMStrategy):
        name = "corrupt_hook_probe"

        def before_step(self, sim, workload, idx, step):
            sim.host_write("A")

    temp_strategy(CorruptHook())
    findings = check_contracts(["corrupt_hook_probe"])
    ids = rule_ids(findings)
    assert "UMC103" in ids
    f = next(f for f in findings if f.rule_id == "UMC103")
    assert f.region == "corrupt_hook_probe"
    assert "host_write" in f.message and "before_step" in f.message


def test_umc103_corrupting_serving_step(temp_strategy):
    class CorruptServing(var.UMStrategy):
        name = "corrupt_serving_probe"

        def serving_step(self, sim, live):
            for name in list(sim.regions):
                if name.startswith("kv/"):
                    sim.free(name)
                    return

    temp_strategy(CorruptServing())
    findings = check_contracts(["corrupt_serving_probe"])
    f = next(f for f in findings if f.rule_id == "UMC103")
    assert "free" in f.message and "serving_step" in f.message


def test_umc103_findings_equal_reference(temp_strategy):
    """The same corrupting hook in both packages: the same findings."""
    def corrupt(base):
        class CorruptHook(base):
            name = "corrupt_both_probe"

            def before_step(self, sim, workload, idx, step):
                sim.host_write("A")
        return CorruptHook()

    temp_strategy(corrupt(var.UMStrategy))
    r_var.register(corrupt(r_var.UMStrategy), replace=True)
    try:
        want = r_contracts.check_contracts(["corrupt_both_probe"])
    finally:
        r_var._REGISTRY.pop("corrupt_both_probe", None)
    got = check_contracts(["corrupt_both_probe"])
    assert got and finding_tuples(got) == finding_tuples(want)


def test_sanctioned_hook_ops_are_hints_only():
    mutators = {"alloc", "free", "host_write", "host_read", "kernel",
                "explicit_copy_to_device", "explicit_alloc",
                "explicit_copy_to_host"}
    assert not SANCTIONED_HOOK_OPS & mutators


def test_probe_actually_exercises_hooks():
    """The adaptive tier's thrash-shedding unadvise must appear,
    phase-tagged, in the probe recording."""
    rec = RecordingSim(UMSimulator(contracts.PROBE_PLATFORM))
    strategy = var.get_strategy("um_adaptive_advise")
    probe = copy.copy(strategy)
    orig = strategy.before_step

    def tagged(sim, workload, idx, step):
        with rec.phase("before_step"):
            orig(sim, workload, idx, step)

    probe.before_step = tagged
    probe.lower(contracts.probe_workload(), rec)
    hook_ops = [op for op in rec.ops if op.phase == "before_step"]
    assert hook_ops, "probe workload never triggered the adaptive hook"
    assert {op.name for op in hook_ops} <= SANCTIONED_HOOK_OPS


def test_contract_rules_catalog_disjoint_from_lint():
    assert not set(CONTRACT_RULES) & set(RULES)
    assert all(sev == "error" for sev, _ in CONTRACT_RULES.values())


# ---------------------------------------------------------------------------
# the recording proxy
# ---------------------------------------------------------------------------

def _ops_repr(ops):
    return [repr((op.name, op.args, op.kwargs, op.phase)) for op in ops]


@pytest.mark.parametrize("variant", ("um", "um_both", "um_prefetch_pipelined",
                                     "um_adaptive_advise", "um_hybrid_counters",
                                     "um_pinned_zero_copy", "explicit"))
def test_recording_sim_bit_identical_serving(variant):
    """A serving trace driven through the proxy: the same report, bit for
    bit, as the unwrapped simulator, and the same recorded ops as the
    reference's proxy on the reference's engine."""
    reqs = get_pattern("poisson_short").generate(salt=f"rec:{variant}")
    plain = UMSimulator(plat.PLATFORMS["p9-volta-nvlink"])
    s_plain = serve(plain, var.get_strategy(variant), reqs, 1.5)
    wrapped = UMSimulator(plat.PLATFORMS["p9-volta-nvlink"])
    rec = RecordingSim(wrapped)
    s_rec = serve(rec, var.get_strategy(variant), reqs, 1.5)
    assert dataclasses.asdict(wrapped.finish()) == dataclasses.asdict(plain.finish())
    assert [dataclasses.astuple(r) for r in s_rec.served] == \
        [dataclasses.astuple(r) for r in s_plain.served]
    assert rec.ops and all(op.phase is None for op in rec.ops)

    rsim = RUMSimulator(r_plat.PLATFORMS["p9-volta-nvlink"])
    rrec = r_trace.RecordingSim(rsim)
    from repro.umbench.serving.scheduler import serve as r_serve
    from repro.umbench.serving.traffic import get_pattern as r_get_pattern
    r_serve(rrec, r_var.get_strategy(variant),
            r_get_pattern("poisson_short").generate(salt=f"rec:{variant}"), 1.5)
    assert _ops_repr(rec.ops) == _ops_repr(rrec.ops)


@pytest.mark.parametrize("app,variant,regime", (
    ("bs", "um_advise", "oversubscribed"), ("cg", "um_both", "in_memory"),
    ("fdtd3d", "um_prefetch_adaptive", "oversubscribed"),
    ("graph500", "um_hybrid_counters", "oversubscribed_2x")))
def test_recording_sim_bit_identical_workload(app, variant, regime):
    """A matrix cell's workload lowered through the proxy: the same report
    as ``harness.run_cell``'s, and the proxy's writes pass through
    (``sim.t_device`` set through it lands on the simulator)."""
    p = plat.PLATFORMS["grace-hopper-c2c"]
    w = harness.WORKLOADS[app](harness.REGIMES[regime] * p.device_mem_gb * 2**30)
    sim = UMSimulator(p)
    rec = RecordingSim(sim)
    var.get_strategy(variant).lower(w, rec)
    got = sim.finish()
    want = harness.run_cell(app, variant, "grace-hopper-c2c", regime).report
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    rec.t_device = 123.0
    assert sim.t_device == 123.0
    names = {op.name for op in rec.ops}
    assert {"alloc", "kernel"} <= names


@pytest.mark.parametrize("pattern,strategy,platform,regime", cli.SERVING_CELLS + (
    ("poisson_short", "explicit", "p9-volta-nvlink", "kv_200"),
    ("poisson_short", "svm_remote", "intel-volta-pcie", "kv_150"),
    ("bursty", "um_pinned_zero_copy", "intel-volta-pcie", "kv_150"),
))
def test_record_serving_ops_equal_reference(pattern, strategy, platform, regime):
    """The lint-ready op streams and the raw recordings the bounds pass
    replays equal the reference's; error-severity lint findings: none."""
    got = record_serving_ops(pattern, strategy, platform, regime)
    want = r_trace.record_serving_ops(pattern, strategy, platform, regime)
    assert got == want
    raw = record_serving_ops(pattern, strategy, platform, regime, raw=True)
    assert _ops_repr(raw) == _ops_repr(r_trace.record_serving_ops(
        pattern, strategy, platform, regime, raw=True))
    assert to_lint_ops(raw) == got
    if strategy == "svm_remote" and platform == "intel-volta-pcie":
        assert got == []                # gated off: nothing recorded
        return
    assert got, "no ops recorded — probe wiring broken"
    assert not [f for f in lint_ops(got) if f.severity == "error"]


def test_serving_cell_bounds_clean_and_violation_caught(monkeypatch):
    """run_serving_cell(bounds=True): a clean engine passes; an engine
    whose batched fault counter is broken is refused with
    error_kind="bounds"."""
    cell = run_serving_cell("poisson_short", "um", "p9-volta-nvlink", "kv_100",
                            bounds=True)
    assert cell.error is None and cell.report is not None
    monkeypatch.setattr(UMSimulator, "_n_fault_events", lambda self, r, ids: 0)
    bad = run_serving_cell("poisson_short", "um", "p9-volta-nvlink", "kv_100",
                           bounds=True)
    assert bad.report is None and bad.error_kind == "bounds"
    assert "n_faults" in bad.error


# ---------------------------------------------------------------------------
# the CLI against ``python -m repro.umbench.analysis``
# ---------------------------------------------------------------------------

def _port_cli(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue().splitlines()


def _reference_cli(argv):
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-m", "repro.umbench.analysis", *argv],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    return proc.returncode, proc.stdout.splitlines()


@pytest.mark.parametrize("argv", ([], ["--all-apps"], ["--serving"], ["--contracts"],
                                  ["--contracts", "--serving"], ["--strict"],
                                  ["--all-apps", "--strict"], ["--list-rules"],
                                  ["--bounds"]), ids=lambda a: " ".join(a) or "all")
def test_cli_equals_reference(argv):
    got = _port_cli(argv)
    want = _reference_cli(argv)
    assert got == want
    assert got[0] == 0


def test_cli_runs_without_jax():
    code = ("import sys; sys.modules['jax'] = None\n"
            "from repro_torch.umbench.analysis.__main__ import main\n"
            "rc = main(['--contracts', '--serving'])\n"
            "loaded = [m for m in sys.modules if m == 'repro' or m.startswith('repro.')]\n"
            "assert not loaded, loaded\n"
            "sys.exit(rc)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.splitlines()[-1] == \
        f"umlint: {len(cli.SERVING_CELLS) + len(EXPECTED_GATES)} subjects checked, " \
        "0 fatal finding(s)"


def _fake_pass(findings):
    return lambda: [("fixture", findings)]


def _both(monkeypatch, attr, findings, r_findings, argv):
    monkeypatch.setattr(cli, attr, _fake_pass(findings))
    monkeypatch.setattr(r_cli, attr, _fake_pass(r_findings))
    got = _port_cli(argv)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = r_cli.main(argv)
    assert got == (rc, buf.getvalue().splitlines()), argv
    return got[0]


def test_cli_exit_codes_split_errors_from_strict_warnings(monkeypatch):
    """Exit 1 = error findings, exit 2 = strict-armed warnings only,
    exit 0 = clean (or warnings without --strict), as the reference."""
    from repro.umbench.analysis.lint import Finding as RFinding
    warn = ("UML004", "warning", 0, "A", "dead region")
    err = ("UML002", "error", 1, "A", "use after free")
    cases = (([warn], ["--all-apps"], 0), ([warn], ["--all-apps", "--strict"], 2),
             ([warn, err], ["--all-apps"], 1), ([warn, err], ["--all-apps", "--strict"], 1),
             ([], ["--all-apps"], 0), ([], ["--all-apps", "--strict"], 0))
    for found, argv, rc in cases:
        assert _both(monkeypatch, "lint_all_apps", [Finding(*f) for f in found],
                     [RFinding(*f) for f in found], argv) == rc, (found, argv)


def test_cli_serving_warnings_not_strict_fatal(monkeypatch):
    """Serving-trace warnings are non-fatal even under --strict; errors
    are fatal."""
    from repro.umbench.analysis.lint import Finding as RFinding
    warn = ("UML004", "warning", 0, "kv/1/0", "dead region")
    err = ("UML002", "error", 1, "kv/1/0", "use after free")
    assert _both(monkeypatch, "lint_serving", [Finding(*warn)], [RFinding(*warn)],
                 ["--serving", "--strict"]) == 0
    assert _both(monkeypatch, "lint_serving", [Finding(*warn), Finding(*err)],
                 [RFinding(*warn), RFinding(*err)], ["--serving"]) == 1


def test_cli_contract_and_bounds_failures_exit_1(monkeypatch):
    """A contract violation and a bounds violation each exit 1 with the
    reference's lines (the port's ``h100-host`` named where the
    reference names its own host platform)."""
    monkeypatch.setitem(contracts.EXPECTED_GATES, "um", "coherent_fabric")
    monkeypatch.setitem(r_contracts.EXPECTED_GATES, "um", "coherent_fabric")
    got = _port_cli(["--contracts"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = r_cli.main(["--contracts"])
    assert got[0] == rc == 1
    assert [ln.replace("h100-host", "tpu-v5e-host") for ln in got[1]] == \
        buf.getvalue().splitlines()

    monkeypatch.setattr(harness, "WORKLOADS", {"bs": harness.WORKLOADS["bs"]})
    monkeypatch.setattr(rh, "WORKLOADS", {"bs": rh.WORKLOADS["bs"]})
    monkeypatch.setattr(UMSimulator, "_n_fault_events", lambda self, r, ids: 0)
    monkeypatch.setattr(RUMSimulator, "_n_fault_events", lambda self, r, ids: 0)
    got = _port_cli(["--bounds"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = r_cli.main(["--bounds"])
    assert got == (rc, buf.getvalue().splitlines())
    assert rc == 1 and "violation" in got[1][-1] and not got[1][-1].endswith(" 0 violation(s)")
