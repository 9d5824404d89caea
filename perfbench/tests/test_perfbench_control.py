"""The control, the reference put in the program's place in fp8 (the step
below the served bf16), comes out not correct under each cell's own
limits, at sizes a CPU test run can hold.  On the card it ran at the
cells' own sizes (``perfbench/control.py``; readings in the checks
files)."""
from __future__ import annotations

import pytest
import torch

from perfbench import check, spec
from perfbench.control import control_numbers
from perfbench.tests.helpers import tiny_file

BENCH = spec.load_benchmark()
CPU = torch.device("cpu")


@pytest.mark.parametrize("cell", ["starcoder2-3b.train", "starcoder2-3b.train-offload"])
def test_the_control_fails_a_training_cell(tiny_port, cell):
    w = spec.workload(BENCH, cell)
    traffic = spec.load_traffic(w["traffic"])
    traffic.update(batch=4, seq_len=32)
    numbers = control_numbers(BENCH, w, tiny_file(w["config"]), traffic, 2**31 + 9, 0.1, CPU)
    assert not check.judge(numbers, spec.load_check(cell)["limits"]), numbers


@pytest.mark.parametrize("cell", ["qwen2-7b.decode", "qwen2-7b.decode-wide", "qwen2-7b.prefill"])
def test_the_control_fails_a_serving_cell(port_sized, cell):
    """Logits spread with width, depth and vocabulary, and the widest gap
    with the tokens compared: d 1,024, 8 layers, 65,536 ids, 768 tokens."""
    w = spec.workload(BENCH, cell)
    file = tiny_file(w["config"])
    file.update(hidden_size=1024, num_hidden_layers=8, num_attention_heads=16,
                intermediate_size=3072, vocab_size=65536)
    port_sized[w["config"]] = file
    traffic = spec.load_traffic(w["traffic"])
    drawn = not isinstance(traffic["prompt_len"], int)
    traffic.update(batch=8, prompt_len={"shuffled": [24, 32]} if drawn else 32, gen=96,
                   sample_rows=8)
    numbers = control_numbers(BENCH, w, file, traffic, 2**31 + 9, 0.01, CPU)
    assert not check.judge(numbers, spec.load_check(cell)["limits"]), numbers
