"""Whole runs of the cells at tiny sizes on the CPU: the harness's look
for a card skipped, the rest of a run driven, with the timed path sound
and then broken underneath, each fault a cell can have coming out as not
``correct`` under the cell's own limits.  The cells run on one card, so no
exchange between cards can be left out."""
from __future__ import annotations

import time

import pytest
import torch

from perfbench import cells, faults, spec
from perfbench.tests.helpers import tiny_file, tiny_traffic

BENCH = spec.load_benchmark()
CPU = torch.device("cpu")


def run(cell_name: str, seed: int = 2**31 + 5) -> dict:
    cell = spec.workload(BENCH, cell_name)
    return cells.run_cell(BENCH, cell, tiny_file(cell["config"]), tiny_traffic(cell["traffic"]),
                          spec.load_check(cell_name), seed, 0.2, False, CPU, time.perf_counter())


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_a_sound_run_is_correct(tiny_port, cell):
    res = run(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    want = {m["name"] for m in spec.metrics_for(BENCH, cell, False)}
    assert set(res["metrics"]) == want and all(m["value"] > 0 for m in res["metrics"].values())


@pytest.mark.parametrize("cell, fault", [
    ("starcoder2-3b.train", "frozen_state"), ("starcoder2-3b.train-offload", "frozen_state"),
    ("starcoder2-3b.train", "half_batch"), ("starcoder2-3b.train-offload", "half_batch"),
    ("qwen2-7b.decode", "altered_token"), ("qwen2-7b.decode-wide", "altered_token"),
    ("qwen2-7b.prefill", "altered_token")])
def test_each_fault_the_cell_can_have_is_caught(tiny_port, cell, fault):
    with faults.planted(fault):
        res = run(cell)
    assert not res["correct"], res["checks"]
    if fault == "frozen_state":
        assert res["checks"]["grad_gap"]["value"] == pytest.approx(1.0)
