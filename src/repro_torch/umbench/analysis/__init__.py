"""umlint — static trace analysis, engine invariant auditing and static
transfer bounds (DESIGN.md §14, §16): the port's copy of the three passes
of ``repro.umbench.analysis`` that the harness calls.

* :func:`lint_workload` / :func:`lint_ops` — dataflow rules UML001-UML011
  over workload traces and recorded op streams (``run_cell(lint=True)``);
* :func:`check_invariants` — the opt-in runtime audit behind
  ``UMSimulator(..., audit=True)`` (``run_cell(audit=True)``);
* :func:`workload_bounds` / :func:`ops_bounds` / :func:`verify_cell` —
  umbound, the symbolic residency abstract interpretation deriving
  provable per-cell fault/transfer bounds (``run_cell(bounds=True)``,
  ``harness.bounds_failure``).

The reference's ``contracts``, ``trace`` and the CLI (``__main__``) drive
the serving sweep (``umbench/serving``) and come with its port.
"""
from repro_torch.umbench.analysis.audit import AuditError, INVARIANTS, check_invariants
from repro_torch.umbench.analysis.bounds import (
    QUANTITIES,
    AbstractSim,
    CellBounds,
    bounds_for_cell,
    ops_bounds,
    verify_cell,
    workload_bounds,
)
from repro_torch.umbench.analysis.lint import Finding, RULES, lint_ops, lint_workload

__all__ = [
    "AbstractSim",
    "AuditError",
    "CellBounds",
    "Finding",
    "INVARIANTS",
    "QUANTITIES",
    "RULES",
    "bounds_for_cell",
    "check_invariants",
    "lint_ops",
    "lint_workload",
    "ops_bounds",
    "verify_cell",
    "workload_bounds",
]
