"""Shared by the benchmark's own tests: the repository's root, and tiny
copies of the configurations and traffic mixes that ``BENCHMARK.json``
names, each taken from its own file and form, so that a new cell needs no
edit here."""
from __future__ import annotations

import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

SHAPE_LIST = 3     # places kept of a shape's list
PROMPT_CUT = 64    # a prompt of p tokens becomes ceil(p / 64)
EVERY_ROW = 64     # sample_rows at these sizes: every served row checked


def tiny_file(name: str) -> dict:
    """Configuration ``name``'s file cut to its form's tiny copy
    (``forms/<model_type>.py``'s ``tiny``)."""
    from perfbench import spec
    from perfbench.modelspec import load_form

    file = spec.load_config(name)
    return load_form(file["model_type"]).tiny(file)


def _cut(value, rule):
    """A shape's number, or each of the first places of its list, by ``rule``."""
    if isinstance(value, int):
        return rule(value)
    return {"shuffled": [rule(v) for v in value["shuffled"][:SHAPE_LIST]]}


def tiny_traffic(name: str) -> dict:
    """Mix ``name``'s file at a size a CPU run holds, by a rule on its own
    keys.  Serve: batch at most 2, prompts cut 64-fold, gen at most 8, every row sampled; lists
    keep their first three places, so that pairs stay pairs.  Train:
    batch at most 4, sequences at most 16."""
    from perfbench import spec

    traffic = spec.load_traffic(name)
    if traffic["kind"] == "train":
        return {**traffic, "batch": min(traffic["batch"], 4),
                "seq_len": min(traffic["seq_len"], 16)}
    return {**traffic, "batch": _cut(traffic["batch"], lambda b: min(b, 2)),
            "prompt_len": _cut(traffic["prompt_len"], lambda p: math.ceil(p / PROMPT_CUT)),
            "gen": min(traffic["gen"], 8), "sample_rows": EVERY_ROW}
