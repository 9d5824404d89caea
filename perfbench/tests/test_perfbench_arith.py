"""The yardstick's arithmetic against hand-computed values: the FLOP and
byte bounds, the percentile, the profiler reduction and the readers."""
from __future__ import annotations

import dataclasses

import pytest
import torch

from perfbench import bounds, spec, stats, trace
from perfbench.modelspec import ModelSpec, matrix_params
from perfbench.serve_cell import TokenClock

# d 8, 2 query heads of 4 and one kv head, a gated MLP of 16, vocab 32, 2
# layers: a layer's matrices are wq 8x8, wk 8x4, wv 8x4, wo 8x8 and three
# 8x16 (576); the head 32x8 (256)
SMALL = ModelSpec(name="small", arch="qwen2-7b", model_type="qwen2", layers=2, d=8, heads=2,
                  kv_heads=1, head_dim=4, d_ff=16, vocab=32, rope_theta=1e4, norm="rmsnorm",
                  norm_eps=1e-6, gated=True, act="silu", qkv_bias=False, tie=False,
                  dtype="bfloat16", window=None)


def test_matrix_parameters():
    assert matrix_params(SMALL) == 2 * 576 + 256


def test_prefill_flops():
    # 2 x 1,152 x B 2 x P 3, the head at 2 rows, 4 Hq Dh x 6 causal pairs x 2 layers x B 2
    assert bounds.prefill_flops(SMALL, 2, 3) == 2 * 1152 * 6 + 2 * 8 * 32 * 2 + 4 * 8 * 6 * 2 * 2


def test_prefill_flops_with_a_window():
    # a window of 2 keys: pairs 1 + 2 + 2
    assert bounds.prefill_flops(dataclasses.replace(SMALL, window=2), 1, 3) == (
        2 * 1152 * 3 + 2 * 8 * 32 + 4 * 8 * 5 * 2)


def test_decode_step_bytes():
    # layers 2 x (576 + 2 norm scales of 8), the final norm 8, the head 256, B 2
    # rows of 8, bf16; K and V of 2 layers x B 2 x (3 + 4 / 2) positions x 1 x 4
    weights = (2 * (576 + 16) + 8 + 256 + 2 * 8) * 2
    kv = 2 * 2 * 2 * 5 * 1 * 4 * 2
    assert bounds.decode_step_bytes(SMALL, 2, 3, 4) == weights + kv


def test_paged_decode_bytes():
    # gen 4 at prompt 3: 3 steps at cache_len 3, 4, 5 read 4 + 5 + 6 live rows
    # of K and V (1 kv head of 4, bf16) and write q's 2 heads x 4 out; each
    # step reads q; 2 layers x B 2
    kv = 2 * (4 + 5 + 6) * 1 * 4 * 2
    q_out = 2 * 3 * 2 * 4 * 2
    assert bounds.paged_decode_bytes(SMALL, 2, 3, 4) == 2 * 2 * (kv + q_out) == 1344
    # the step at cache_len 3 alone: 4 rows, q and out
    assert bounds.paged_step_bytes(SMALL, 2, 3) == 2 * 2 * (2 * 4 * 4 * 2 + 2 * 2 * 4 * 2) == 384
    # a window of 4 keys caps the rows at 4 + 4 + 4
    windowed = dataclasses.replace(SMALL, window=4)
    assert bounds.paged_decode_bytes(windowed, 2, 3, 4) == 2 * 2 * (2 * 12 * 4 * 2 + q_out)
    assert bounds.paged_decode_bytes(SMALL, 2, 3, 1) == 0


def test_serve_call_bound():
    got = bounds.serve_call_bound_s(SMALL, 2, 3, 4)
    want = (bounds.prefill_flops(SMALL, 2, 3) / 989e12
            + 3 * bounds.decode_step_bytes(SMALL, 2, 3, 4) / 3.35e12)
    assert got == pytest.approx(want, rel=1e-15)


def test_train_step_flops():
    assert bounds.train_step_flops(SMALL, 2, 3) == 6 * 1408 * 6 + 12 * 8 * 6 * 2 * 2


@pytest.mark.parametrize("q, want", [(0, 1.0), (50, 2.5), (95, 3.85), (100, 4.0)])
def test_percentile(q, want):
    assert stats.percentile([4, 1, 3, 2], q) == pytest.approx(want)


def test_itl_p95_is_over_all_gaps_not_a_median_of_calls():
    # two calls: 19 gaps of 10 ms and one of 200 (the capture) each, and a
    # third call of 20 gaps of 40 ms: the p95 of all 60 gaps is 40 ms; a
    # median of the calls' own p95s would read 19.5
    gaps = [10.0] * 19 + [200.0] + [10.0] * 19 + [200.0] + [40.0] * 20
    facts = {"kind": "serve", "gaps_ms": gaps}
    read = spec.load_reader("itl_ms_p95").read(facts)
    assert read == pytest.approx(stats.percentile(gaps, 95)) == pytest.approx(40.0)
    per_call = [stats.percentile(gaps[i:i + 20], 95) for i in (0, 20, 40)]
    assert stats.median(per_call) != pytest.approx(read)


def test_readers_read_nothing_where_nothing_is_theirs():
    serve = {"kind": "serve", "trace": None}
    for name in ("train_tokens_per_s", "mfu.train", "optimizer_ms.train",
                 "gemm_roofline.train", "idle_share.serve", "idle_share.train"):
        assert spec.load_reader(name).read(serve) is None


def test_token_times_drop_the_first_step_call_and_end_at_the_return():
    clock = TokenClock()
    clock.marks = [("capture", 1.0), ("step", 1.5), ("step", 2.0), ("step", 3.0)]
    assert clock.token_times(4, 4.0) == [1.0, 2.0, 3.0, 4.0]
    assert clock.marks == []
    with pytest.raises(RuntimeError, match="stamped 0 steps"):
        clock.token_times(4, 5.0)


def test_token_times_need_no_capture_a_call_and_fail_a_call_with_no_step():
    """A step reused across calls captures once or never: the first token
    is read at the call's first stamp, whichever it is.  A call whose
    decode stamps a capture and no step, or too few steps, fails."""
    clock = TokenClock()
    clock.marks = [("step", 1.0), ("step", 2.0), ("step", 3.0)]
    assert clock.token_times(4, 4.0) == [1.0, 2.0, 3.0, 4.0]
    clock.marks = [("capture", 1.0)]
    with pytest.raises(RuntimeError, match="stamped 0 steps, not 3"):
        clock.token_times(4, 5.0)
    clock.marks = [("capture", 1.0), ("step", 2.0), ("step", 3.0)]
    with pytest.raises(RuntimeError, match="stamped 2 steps, not 3"):
        clock.token_times(4, 5.0)
    assert clock.token_times(1, 6.0) == [6.0]


class _Event:
    def __init__(self, name, start, dur, device, annotation=False):
        self._n, self._s, self._d, self._dev, self._a = name, start, dur, device, annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._dev else torch.autograd.DeviceType.CPU

    def is_user_annotation(self):
        return self._a


def test_trace_reduction():
    events = [
        _Event(trace.WINDOW, 0, 100, False, annotation=True),
        _Event(trace.WINDOW, 1, 98, True, annotation=True),  # the window's span on the card
        _Event("a program's range", 2, 50, True, annotation=True),
        _Event("cudaGraphLaunch", 5, 10, False),
        _Event("aten::copy_", 60, 30, False),
        _Event("cudaStreamSynchronize", 55, 40, False),
        _Event("sm90_xmma_gemm_bf16", 10, 20, True),
        _Event("elementwise", 25, 15, True),           # overlaps the GEMM by 5
        _Event("Memcpy HtoD (Pinned -> Device)", 70, 10, True),
        _Event("Memcpy DtoD (Device -> Device)", 85, 5, True),
        _Event("late kernel", 95, 20, True),           # cut at the window's end
    ]
    got = trace.reduce(events)
    assert got["window_s"] == pytest.approx(100e-9)
    assert got["busy_s"] == pytest.approx((30 + 10 + 5 + 5) * 1e-9)
    assert got["gemm_s"] == pytest.approx(20e-9)
    assert got["host_copy_s"] == pytest.approx(10e-9)
    assert got["device_ops"][0] == ["sm90_xmma_gemm_bf16", pytest.approx(20e-9)]
    assert got["kernel_s"] == pytest.approx({
        "sm90_xmma_gemm_bf16": 20e-9, "elementwise": 15e-9, "late kernel": 5e-9,
        "Memcpy HtoD (Pinned -> Device)": 10e-9, "Memcpy DtoD (Device -> Device)": 5e-9})
    assert got["kernel_n"] == {
        "sm90_xmma_gemm_bf16": 1, "elementwise": 1, "late kernel": 1,
        "Memcpy HtoD (Pinned -> Device)": 1, "Memcpy DtoD (Device -> Device)": 1}
    # gaps: 0-10 (graph launch), 40-70 (the sync at its middle), 80-85, 90-95
    assert [g for _, g in got["idle_gaps"]] == pytest.approx([30e-9, 10e-9, 5e-9, 5e-9])
    assert got["idle_gaps"][0][0] == "host: cudaStreamSynchronize"
    assert got["idle_gaps"][1][0] == "host: cudaGraphLaunch"


def test_trace_reduction_without_device_work_fails():
    with pytest.raises(RuntimeError, match="no device operation"):
        trace.reduce([_Event(trace.WINDOW, 0, 100, False)])


def test_every_kernel_keeps_its_time_and_the_breakdown_its_top_ten():
    kernels = [_Event(f"kernel {i}", 10 * i, i + 1, True) for i in range(14)]
    again = _Event("kernel 0", 150, 1, True)
    got = trace.reduce([_Event(trace.WINDOW, 0, 200, False)] + kernels + [again])
    assert got["kernel_s"] == pytest.approx(
        {f"kernel {i}": (i + 1 + (i == 0)) * 1e-9 for i in range(14)})
    assert got["kernel_n"] == {f"kernel {i}": 1 + (i == 0) for i in range(14)}
    assert [n for n, _ in got["device_ops"]] == [f"kernel {i}" for i in range(13, 3, -1)]


PAGED = {"void (anonymous namespace)::tensor_core::paged_tc_kernel<128, 1>(CUtensorMap)": 6e-10,
         "paged_merge_kernel(float const*, int const*)": 1e-10,
         "void (anonymous namespace)::paged_decode_kernel<float, 4, 2>(float const*)": 1.024e-10,
         "nvjet_tst_256x16_64x6_4x1_v_bz_NNT": 5e-9, "Memcpy DtoD (Device -> Device)": 1e-9}


# launches: 2 layers x 3 steps of the work-item kernel or the CUDA-core one
PAGED_N = dict(zip(PAGED, [4, 4, 2, 6, 1]))


def _serve_facts(**kw):
    facts = {"kind": "serve", "spec": SMALL, "traced_call": {"batch": 2, "prompt_len": 3, "gen": 4},
             "trace": {"kernel_s": PAGED, "kernel_n": PAGED_N}, "spans": None}
    return {**facts, **kw}


def _launches(tc: int, decode: int) -> dict:
    names = list(PAGED)
    return {**PAGED_N, names[0]: tc, names[1]: tc, names[2]: decode}


@pytest.mark.parametrize("name", ["paged_roofline.serve", "paged_roofline.prompt"])
def test_paged_roofline_reads_the_paged_kernels_time_against_their_bytes(name):
    reader = spec.load_reader(name, "serve")
    # the gen - 1 = 3 steps: 1,344 bytes at 3.35e12 B/s over the three paged
    # kernels' 8.024e-10 s
    read = reader.read(_serve_facts())
    assert read == pytest.approx(100 * 1344 / 3.35e12 / 8.024e-10)
    assert 49 < read < 51
    assert reader.read(_serve_facts(trace={"kernel_s": {
        k: v for k, v in PAGED.items() if "paged" not in k}, "kernel_n": PAGED_N})) is None
    assert reader.read(_serve_facts(trace=None)) is None
    assert reader.read({"kind": "train", "trace": {}}) is None


@pytest.mark.parametrize("name", ["paged_roofline.serve", "paged_roofline.prompt"])
def test_paged_roofline_counts_the_steps_the_trace_ran(name):
    reader = spec.load_reader(name, "serve")

    def read(tc, decode):
        return reader.read(_serve_facts(trace={"kernel_s": PAGED, "kernel_n": _launches(tc, decode)}))

    # two more steps (a capture's warm-ups) at the first step's cache length
    # 3: 1,344 + 2 x 384 bytes in the same time
    assert read(8, 2) == pytest.approx(100 * (1344 + 2 * 384) / 3.35e12 / 8.024e-10)
    assert read(6, 0) == pytest.approx(read(4, 2))
    # launches that are no whole number of steps, or fewer than the call's
    assert read(5, 2) is None
    assert read(2, 2) is None


def test_decode_step_ms_reads_the_median_device_time_of_serve_step():
    reader = spec.load_reader("decode_step_ms.serve")
    steps = {"count": 3, "host_ms": [0.1, 0.1, 0.2], "device_ms": [9.5, 30.0, 9.25]}
    spans = {"by_name": {"serve.step": steps, "serve.token": {**steps, "device_ms": []}},
             "counters": {}}
    assert reader.read(_serve_facts(spans=spans)) == 9.5
    # on the CPU (or with no span of it) nothing is timed on the card
    no_card = {"by_name": {"serve.step": {**steps, "device_ms": []}}, "counters": {}}
    assert reader.read(_serve_facts(spans=no_card)) is None
    assert reader.read(_serve_facts(spans={"by_name": {}, "counters": {}})) is None
    assert reader.read(_serve_facts()) is None
    assert reader.read({"kind": "train", "spans": spans}) is None
