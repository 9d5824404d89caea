"""umlint — static trace/strategy analysis, engine invariant auditing and
static transfer bounds (DESIGN.md §14, §16): the port's copy of
``repro.umbench.analysis``.

Four passes, one CLI (``python -m repro_torch.umbench.analysis``):

* :func:`lint_workload` / :func:`lint_ops` — dataflow rules UML001-UML011
  over workload traces and recorded serving op streams;
* :func:`check_contracts` — platform-gate and hook-whitelist contracts
  UMC101-UMC104 over every registered variant strategy;
* :func:`check_invariants` — the opt-in runtime audit behind
  ``UMSimulator(..., audit=True)``;
* :func:`workload_bounds` / :func:`ops_bounds` / :func:`verify_cell` —
  umbound, the symbolic residency abstract interpretation deriving
  provable per-cell fault/transfer bounds (DESIGN.md §16).
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
from repro_torch.umbench.analysis.contracts import (
    CONTRACT_RULES,
    EXPECTED_GATES,
    SANCTIONED_HOOK_OPS,
    check_contracts,
)
from repro_torch.umbench.analysis.lint import Finding, RULES, lint_ops, lint_workload
from repro_torch.umbench.analysis.trace import (
    Op,
    RecordingSim,
    record_serving_ops,
    to_lint_ops,
)

__all__ = [
    "AbstractSim",
    "AuditError",
    "CONTRACT_RULES",
    "CellBounds",
    "EXPECTED_GATES",
    "Finding",
    "INVARIANTS",
    "Op",
    "QUANTITIES",
    "RULES",
    "RecordingSim",
    "SANCTIONED_HOOK_OPS",
    "bounds_for_cell",
    "check_contracts",
    "check_invariants",
    "lint_ops",
    "lint_workload",
    "ops_bounds",
    "record_serving_ops",
    "to_lint_ops",
    "verify_cell",
    "workload_bounds",
]
