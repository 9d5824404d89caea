"""CLI for the static-analysis passes (DESIGN.md §14): the port's copy of
``python -m repro.umbench.analysis``, with the same flags, output and exit
codes.  ``main(argv)`` returns the exit code, so a caller can run it in
process.

``python -m repro_torch.umbench.analysis`` with no pass flags runs everything:

* ``--all-apps``   lint every builtin workload builder across the extended
                   platform/regime matrix (UML rules);
* ``--serving``    record small serving traces through the proxy and lint
                   the op streams;
* ``--contracts``  check every registered strategy's platform gate and
                   hook whitelist (UMC rules).

``--bounds`` (opt-in, not part of the default run) derives static transfer
bounds for every builtin-app cell of the extended matrix plus a kv_150
serving cell and cross-checks the measured counters (DESIGN.md §16).

Exit status: 1 when any error-severity finding (or bounds violation) is
reported; 2 when — under ``--strict`` — only strict-armed warnings were
found (no errors); 0 otherwise.  The distinct codes let CI treat "the
traces are broken" and "the traces are untidy" differently.
Serving-trace warnings stay non-fatal even under ``--strict``: the
request-driven lifecycle retires regions asynchronously, so a block
allocated just before its request completes is a timing artifact, not a
trace bug (errors there are still real and still fatal).
"""
from __future__ import annotations

import argparse
import sys

from repro_torch.umbench.analysis import audit, contracts, lint, trace

GB = 1 << 30

#: serving cells recorded for linting: strategies spanning the managed,
#: pipelined, and coherent tiers (explicit is omitted — under KV
#: oversubscription it aborts mid-trace and the partial stream is not a
#: meaningful lint subject)
SERVING_CELLS = (
    ("poisson_short", "um", "p9-volta-nvlink", "kv_150"),
    ("poisson_short", "um_both", "p9-volta-nvlink", "kv_150"),
    ("poisson_short", "um_prefetch_pipelined", "p9-volta-nvlink", "kv_200"),
    ("poisson_short", "um_hybrid_counters", "p9-volta-nvlink", "kv_150"),
)


def lint_all_apps() -> list[tuple[str, list[lint.Finding]]]:
    """Lint every builtin app across the extended matrix, sized exactly as
    ``harness.run_cell`` sizes the cell."""
    from repro_torch.umbench import harness, platforms as plat

    out = []
    for app, build in sorted(harness.WORKLOADS.items()):
        for pname in harness.EXTENDED_PLATFORMS:
            p = plat.PLATFORMS[pname]
            capacity = int(p.device_mem_gb * GB)
            for regime in harness.EXTENDED_REGIMES:
                w = build(harness.REGIMES[regime] * p.device_mem_gb * GB)
                findings = lint.lint_workload(
                    w, capacity=capacity,
                    expect_oversubscription=(regime != "in_memory"))
                out.append((f"{app}:{pname}:{regime}", findings))
    return out


def lint_serving() -> list[tuple[str, list[lint.Finding]]]:
    out = []
    for pattern, strategy, platform, regime in SERVING_CELLS:
        ops = trace.record_serving_ops(pattern, strategy, platform, regime)
        label = f"serve_{pattern}:{platform}:{strategy}:{regime}"
        out.append((label, lint.lint_ops(ops)))
    return out


def _print(label: str, findings) -> None:
    for f in findings:
        print(f"{label}: {f}")


#: the serving cell the bounds pass cross-checks (an oversubscribed
#: migrating cell: the widened abstract domain, not just the exact phase)
BOUNDS_SERVING_CELL = ("poisson_short", "um", "p9-volta-nvlink", "kv_150")


def check_bounds(granularity: str = "group") -> tuple[int, int]:
    """Derive and cross-check static bounds (DESIGN.md §16) over every
    builtin-app cell of the extended matrix, plus one oversubscribed
    serving cell.  Returns (cells checked, violations); each violation is
    printed as it is found."""
    from repro_torch.umbench import harness
    from repro_torch.umbench.serving.sweep import run_serving_cell
    checked = violations = 0
    for app in sorted(harness.WORKLOADS):
        for pname in harness.EXTENDED_PLATFORMS:
            for regime in harness.EXTENDED_REGIMES:
                for variant in harness.EXTENDED_VARIANTS:
                    cell = harness.run_cell(app, variant, pname, regime,
                                            granularity, bounds=True)
                    if cell.error_kind == "bounds":
                        violations += 1
                        checked += 1
                        print(f"{app}:{pname}:{variant}:{regime}: "
                              f"{cell.error}")
                    elif cell.report is not None:
                        checked += 1
    pattern, strategy, platform, regime = BOUNDS_SERVING_CELL
    cell = run_serving_cell(pattern, strategy, platform, regime,
                            granularity, bounds=True)
    if cell.error_kind == "bounds":
        violations += 1
        checked += 1
        print(f"serve_{pattern}:{platform}:{strategy}:{regime}: "
              f"{cell.error}")
    elif cell.report is not None:
        checked += 1
    return checked, violations


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.umbench.analysis",
        description="umlint: static trace/strategy analysis (DESIGN.md §14)")
    ap.add_argument("--all-apps", action="store_true",
                    help="lint every builtin app across the extended matrix")
    ap.add_argument("--serving", action="store_true",
                    help="record and lint serving traces")
    ap.add_argument("--contracts", action="store_true",
                    help="check strategy platform-gate and hook contracts")
    ap.add_argument("--strict", action="store_true",
                    help="fail on warnings too (serving warnings excepted)")
    ap.add_argument("--bounds", action="store_true",
                    help="derive static transfer bounds for the builtin-app "
                         "matrix (+ a serving cell) and cross-check the "
                         "measured counters")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and audit invariants")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rid, (sev, desc) in {**lint.RULES,
                                 **contracts.CONTRACT_RULES}.items():
            print(f"{rid}  {sev:7s}  {desc}")
        for inv in audit.INVARIANTS:
            print(f"audit   invariant  {inv}")
        return 0

    if args.bounds:
        b_checked, b_viol = check_bounds()
        print(f"umbound: {b_checked} cells checked, "
              f"{b_viol} violation(s)")
        return 1 if b_viol else 0

    run_all = not (args.all_apps or args.serving or args.contracts)
    errors = 0
    strict_warnings = 0
    checked = 0
    if args.all_apps or run_all:
        for label, findings in lint_all_apps():
            checked += 1
            _print(label, findings)
            errors += sum(1 for f in findings if f.severity == "error")
            if args.strict:
                strict_warnings += sum(1 for f in findings
                                       if f.severity != "error")
    if args.serving or run_all:
        for label, findings in lint_serving():
            checked += 1
            _print(label, findings)
            errors += sum(1 for f in findings if f.severity == "error")
    if args.contracts or run_all:
        findings = contracts.check_contracts()
        checked += len(contracts.EXPECTED_GATES)
        _print("contracts", findings)
        errors += sum(1 for f in findings if f.severity == "error")
        if args.strict:
            strict_warnings += sum(1 for f in findings
                                   if f.severity != "error")
    fatal = errors + strict_warnings
    print(f"umlint: {checked} subjects checked, "
          f"{fatal} fatal finding(s)")
    # errors are exit 1; strict-armed warnings alone are exit 2 — distinct,
    # so CI can treat broken traces and untidy traces differently
    return 1 if errors else (2 if strict_warnings else 0)


if __name__ == "__main__":
    sys.exit(main())
