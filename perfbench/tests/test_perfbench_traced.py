"""What a ``--trace 1`` run hands its readers, on the CPU at tiny sizes:
the cell's ``ModelSpec``, the traced call's or step's shape, every
kernel's time and launches, and in a serve cell the spans of the traced
call made once more inside the program's ``spans.recording()``; and the
window and the check the same as in an untraced run.  The profiler needs
a card: a stand-in runs the call and returns a reduced trace of made-up
kernels."""
from __future__ import annotations

import itertools
import time

import pytest
import torch

from perfbench import cells, serve_cell, spec, train_cell, trace
from perfbench import weights as W
from perfbench.bounds import PEAK_BYTES_PER_S, paged_decode_bytes, paged_step_bytes
from perfbench.modelspec import spec_of
from perfbench.tests.helpers import tiny_file, tiny_traffic

BENCH = spec.load_benchmark()
CPU = torch.device("cpu")
SEED = 2**31 + 41
KERNELS = {"void (anonymous namespace)::tensor_core::paged_tc_kernel<128, 1>()": 2e-6,
           "paged_merge_kernel()": 1e-6, "nvjet_tst_256x16_64x6_4x1_v_bz_NNT": 1e-3}


class StandIn:
    """``trace.profiled`` replaced: the call runs once (``ran``), and the
    trace is ``KERNELS`` in a window of 10 ms, half of it busy, each
    launched ``launches`` times."""

    def __init__(self):
        self.ran, self.launches = [], 1

    def __call__(self, fn, device):
        self.ran.append(fn())
        return {"window_s": 0.01, "busy_s": 0.005, "gemm_s": 1e-3, "host_copy_s": 0.0,
                "kernel_s": dict(KERNELS), "kernel_n": dict.fromkeys(KERNELS, self.launches),
                "device_ops": [], "idle_gaps": []}


@pytest.fixture
def profiled(monkeypatch):
    stand_in = StandIn()
    monkeypatch.setattr(trace, "profiled", stand_in)
    return stand_in


@pytest.fixture
def serve_calls(monkeypatch):
    """The keyword arguments of every ``launch.serve.serve`` call."""
    import repro_torch.launch.serve as serve_mod

    seen, real = [], serve_mod.serve

    def serve(*args, **kwargs):
        seen.append(kwargs)
        return real(*args, **kwargs)

    monkeypatch.setattr(serve_mod, "serve", serve)
    return seen


def _ticking(monkeypatch):
    """The host clock advances 1 ms a read: a window holds the same calls
    however loaded the CPU is."""
    ticks = itertools.count()
    monkeypatch.setattr(time, "perf_counter", lambda: next(ticks) * 1e-3)


def test_a_traced_serve_run_records_the_profiled_call_again(tiny_port, profiled, serve_calls,
                                                            monkeypatch):
    file, traffic = tiny_file("qwen2-7b"), tiny_traffic("decode-wide")
    m = spec_of("qwen2-7b", file)
    _ticking(monkeypatch)
    facts, numbers = serve_cell.run(m, file, traffic, SEED, 0.05, True, CPU, time.perf_counter())
    n = len(facts["served_calls"])
    # the round's median shape, whatever the seed and the window's length
    shape = serve_cell.traced_shape(traffic)
    assert shape["prompt_len"] == sorted(traffic["prompt_len"]["shuffled"])[1]
    assert facts["spec"] == m and facts["traced_call"] == shape
    assert facts["trace"]["kernel_s"] == KERNELS and len(profiled.ran) == 1
    # the window's calls, the recorded call and the profiled one, which
    # repeats it: the same shape and the same prompts
    assert len(serve_calls) == n + 2
    for kw in serve_calls[-2:]:
        assert (kw["batch"], kw["prompt_len"], kw["gen"]) == tuple(shape.values())
        assert torch.equal(kw["prompts"][0]["tokens"],
                           W.tokens(SEED, "prompt", n, (shape["batch"], shape["prompt_len"]),
                                    m.vocab, CPU))
    by_name, steps = facts["spans"]["by_name"], shape["gen"] - 1
    for name, count in (("serve.call", 1), ("serve.prefill", 1), ("serve.decode_capture", 1),
                        ("serve.release", 2), ("serve.token", steps), ("serve.step", steps)):
        assert by_name[name]["count"] == len(by_name[name]["host_ms"]) == count, name
    assert by_name["serve.step"]["device_ms"] == []  # nothing is timed on the card here
    # a layer a step routed to plain attention (the paged kernel is a card's);
    # the allocator's counts are a card's too
    assert facts["spans"]["counters"] == {"attn.decode_plain": steps * m.layers}
    assert facts["failed"] == 0


def test_tracing_leaves_the_window_and_the_check_as_they_were(tiny_port, profiled, monkeypatch):
    file, traffic = tiny_file("qwen2-7b"), tiny_traffic("decode-wide")
    m = spec_of("qwen2-7b", file)
    runs = []
    for traced in (False, True):
        _ticking(monkeypatch)
        runs.append(serve_cell.run(m, file, traffic, SEED, 0.05, traced, CPU,
                                   time.perf_counter()))
    (plain, plain_numbers), (traced, traced_numbers) = runs
    assert traced_numbers == plain_numbers
    for key in ("setup_s", "window_s", "generated", "prompt_tokens", "calls", "gaps_ms",
                "call_bound_s", "attempted", "failed"):
        assert traced[key] == plain[key], key
    assert all((a["tokens"] == b["tokens"]).all()
               for a, b in zip(plain["served_calls"], traced["served_calls"], strict=True))
    assert plain["spans"] is plain["trace"] is plain["traced_call"] is None


def test_a_traced_serve_line_reports_what_its_readers_find(tiny_port, profiled):
    cell = spec.workload(BENCH, "qwen2-7b.decode")
    file, traffic = tiny_file("qwen2-7b"), tiny_traffic("decode")
    m = spec_of("qwen2-7b", file)
    B, P, G = traffic["batch"], traffic["prompt_len"], traffic["gen"]
    # the call's gen - 1 steps and a capture's 2 warm-ups, a launch a layer each
    profiled.launches = m.layers * (G - 1 + 2)
    res = cells.run_cell(BENCH, cell, file, traffic, spec.load_check(cell["name"]), SEED, 0.05,
                         True, CPU, time.perf_counter())
    assert res["correct"], res["checks"]
    want = {m["name"] for m in spec.metrics_for(BENCH, cell["name"], True)}
    # serve.step has no device time on the CPU, so decode_step_ms.serve is left out
    assert set(res["metrics"]) == want - {"decode_step_ms.serve"}
    moved = paged_decode_bytes(m, B, P, G) + 2 * paged_step_bytes(m, B, P)
    assert res["metrics"]["paged_roofline.serve"]["value"] == pytest.approx(
        100 * moved / PEAK_BYTES_PER_S / 3e-6)
    assert res["metrics"]["idle_share.serve"]["value"] == pytest.approx(50.0)


@pytest.mark.parametrize("mix", ["train", "train-offload"])
def test_a_traced_train_run_hands_its_readers_the_spec_and_the_step(tiny_port, profiled,
                                                                   monkeypatch, mix):
    monkeypatch.setattr(train_cell, "optimizer_ms", lambda *args: 1.0)
    file, traffic = tiny_file("starcoder2-3b"), tiny_traffic(mix)
    m = spec_of("starcoder2-3b", file)
    facts, numbers = train_cell.run(m, file, traffic, SEED, 0.05, True, CPU, time.perf_counter())
    assert facts["spec"] == m and len(profiled.ran) == 1
    assert facts["traced_call"] == {"batch": traffic["batch"], "seq_len": traffic["seq_len"]}
    assert facts["trace"]["kernel_n"] and facts["optimizer_ms"] == 1.0
    assert facts["spans"] is None  # no train span has a reader yet
    assert facts["failed"] == 0 and set(numbers) >= {"loss_gap", "grad_gap"}


@pytest.mark.parametrize("mix", ["train", "train-offload"])
def test_the_spans_summary_of_a_tiny_train_step(tiny_port, mix):
    file, traffic = tiny_file("starcoder2-3b"), tiny_traffic(mix)
    m = spec_of("starcoder2-3b", file)
    _, params, state, step, _ = train_cell.build(m, file, traffic, SEED, CPU)
    batch = W.train_batch(SEED, 0, traffic["batch"], traffic["seq_len"], m.vocab, CPU)
    summary = trace.recorded(lambda: step(params, state, batch, traffic["first_step"]))
    by_name = summary["by_name"]
    phases = {"train.grads", "train.clip", "train.update"}
    if traffic["plan"] == "host":
        phases |= {"train.fetch", "train.offload"}
    assert set(by_name) == {"train.step"} | phases
    assert by_name["train.step"]["count"] == 1
    assert all(by_name[p]["count"] == len(by_name[p]["host_ms"]) >= 1 for p in phases)
    assert all(not e["device_ms"] for e in by_name.values())  # nothing on a card here
    assert summary["counters"] == {}
