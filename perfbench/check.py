"""The numbers that decide ``correct``, each held against its limit in
``checks/<workload>.json``.

Serving: ``logit_gap``, the widest gap by which a served token's logit
lies below the reference's best at its position, over a sample of the
rows served in the window, the reference run over each prompt with its
served tokens.  Greedy tokens only: a token the reference also ranks first
reads 0.

Training: ``loss_gap``, the largest relative gap of a checked step's loss;
``grad_gap``, the worst leaf's gap between the program's and the
reference's norm of the first gradient as the optimizer holds it after one
step (m / (1 - b1)); ``change_gap``, the worst leaf's gap between the
norms of the parameters' change after the checked steps.  A leaf's gap is
taken against the reference's norm of that leaf or of the median leaf,
whichever is larger.  Leaves whose reference gradient is under a
thousandth of the median leaf's (nought but rounding, such as a key bias
under softmax) move under Adam by round-off alone and are left out of
``change_gap``.  ``change_gap_median`` is the median leaf's gap of change:
with int8 moments the third update swings one leaf's change with the
gradient's last bits (PERF.md, the benchmark's Findings), and such a cell
compares the median leaf.
"""
from __future__ import annotations

import math
import statistics

import torch

NOUGHT = 1e-3


def logit_gaps(ref_logits: torch.Tensor, served: torch.Tensor) -> torch.Tensor:
    """ref_logits (R, G, V), served (R, G): max - logit of the served token."""
    got = ref_logits.gather(-1, served.long()[..., None])[..., 0]
    return ref_logits.amax(-1) - got


def leaf_gaps(prog: dict, ref: dict, names) -> dict[str, float]:
    """Each leaf's gap of norms against the reference's norm of that leaf
    or of the median leaf, whichever is larger."""
    names = list(names)
    med = statistics.median(ref[k] for k in names)
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in names}


def train_gaps(prog: dict, ref: dict) -> dict[str, dict[str, float]]:
    """``prog`` and ``ref`` as ``reference.train.run`` returns them: each
    number's gaps, by step (loss) or by leaf."""
    g = ref["grad_norms"]
    med = statistics.median(g.values())
    moving = [k for k in g if g[k] >= NOUGHT * med]
    return {"loss_gap": {f"step {i + 1}": abs(p - r) / abs(r) for i, (p, r) in
                         enumerate(zip(prog["losses"], ref["losses"], strict=True))},
            "grad_gap": leaf_gaps(prog["grad_norms"], g, g),
            "change_gap": leaf_gaps(prog["change_norms"], ref["change_norms"], moving)}


def train_numbers(gaps: dict[str, dict[str, float]]) -> dict[str, float]:
    """The worst of each number's gaps, and ``change_gap_median``, the
    median leaf's gap of change."""
    out = {k: max(v.values()) for k, v in gaps.items()}
    out["change_gap_median"] = statistics.median(gaps["change_gap"].values())
    return out


def worst(gaps: dict[str, dict[str, float]], n: int = 3) -> dict[str, list]:
    """The ``n`` largest gaps of each number, with their steps or leaves."""
    return {k: sorted(v.items(), key=lambda kv: -kv[1])[:n] for k, v in gaps.items()}


def judge(numbers: dict[str, float], limits: dict[str, float]) -> bool:
    """Every number finite and within its limit; a number missing fails."""
    return all(k in numbers and math.isfinite(numbers[k]) and numbers[k] <= lim
               for k, lim in limits.items())
