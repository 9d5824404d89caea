"""The port's span and counter recorder (``repro_torch.spans``) and the
spans the serve call and the train step record, on the CPU.

Off, a span reads the host clock and nothing else: no CUDA event, no
``record_function``, no ``memory_stats``.  On, spans nest (parents, one
call id a root), counters land on the innermost span, device-timed spans
take a pair of timing events (faked here: the CPU has none), a graph's
capture keeps its phases as external events that each replay enters as
spans, and under the profiler each span is a ``record_function`` range
whose stamps, converted to the epoch clock, are the profiler's.  The
device-idle sum by span runs on hand-made kineto events.  The card's own
events (graph event nodes timed by ``elapsed_time``) are checked on the
card by ``chip_spans.py``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import spans  # noqa: E402
from repro_torch.configs import MeshConfig, ShapeConfig, get_config  # noqa: E402
from repro_torch.core.advise import MemorySpace  # noqa: E402
from repro_torch.core.residency import MemoryBudget, ResidencyPlan  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import step as tstep  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402

CUDA = torch.device("cuda")
B, PROMPT, GEN = 2, 8, 5


class _Refused:
    """Stands in for a call the off path must not make."""

    def __init__(self, *args, **kwargs):
        raise AssertionError("called with nothing recording")


class _FakeEvent:
    """A timing event on the CPU: ``elapsed_time`` is the gap between the
    two ``record`` calls in counts of records made."""

    made: list = []
    clock = 0

    def __init__(self, enable_timing=False, external=False):
        assert enable_timing
        self.external, self.at = external, None
        _FakeEvent.made.append(self)

    def record(self, stream=None):
        _FakeEvent.clock += 1
        self.at = _FakeEvent.clock

    def synchronize(self):
        assert self.at is not None

    def elapsed_time(self, end):
        return float(end.at - self.at)


@pytest.fixture
def fake_card(monkeypatch):
    _FakeEvent.made, _FakeEvent.clock = [], 0
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    return _FakeEvent.made


def _serve(**kw):
    return tserve.serve("qwen2-7b", batch=B, prompt_len=PROMPT, gen=GEN, device="cpu", **kw)


def test_off_keeps_nothing_and_makes_no_event(monkeypatch):
    """With no recording a span, even a device-timed one, only reads the
    host clock, ``count`` and ``replayed`` do nothing, a capture collects
    no phase, and neither serve nor a train step makes an event, a
    ``record_function`` range or a ``memory_stats`` call."""
    monkeypatch.setattr(torch.cuda, "Event", _Refused)
    monkeypatch.setattr(torch.cuda, "memory_stats", _Refused)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _Refused)
    with spans.span("outer", CUDA, kind="x") as s:
        spans.count("n", 3)
    assert s.ms >= 0 and s.parent is None and s.call is None and s.counts is None
    with spans.graph_phases() as phases, spans.span("phase", CUDA):
        pass
    assert phases == [] and spans.active() is None
    spans.replayed(phases)
    _serve(record={})
    arch, plan = _train_arch(host=True)
    model, state, step, batch = _train_parts(arch, plan)
    step(model, state, batch, 1)


def test_nesting_gives_parents_and_one_call_id_a_root():
    with spans.recording() as rec:
        with spans.span("a", size=1):
            with spans.span("b"):
                with spans.span("c"):
                    pass
            with spans.span("d"):
                pass
        with spans.span("e"):
            pass
    names = [s.name for s in rec.spans]
    assert names == ["a", "b", "c", "d", "e"]
    a, b, c, d, e = rec.spans
    assert [s.parent for s in rec.spans] == [None, a, b, a, None]
    assert [s.call for s in rec.spans] == [1, 1, 1, 1, 2]
    assert a.attrs == {"size": 1} and rec.named("c") == [c]
    assert all(s.t0 <= s.t1 and s.device_ms is None for s in rec.spans)
    assert a.t0 <= b.t0 <= c.t0 <= c.t1 <= b.t1 <= d.t0 <= d.t1 <= a.t1 <= e.t0
    assert spans.active() is None


def test_counters_attach_to_the_innermost_span():
    with spans.recording() as rec:
        spans.count("loose")
        with spans.span("outer"):
            spans.count("n", 2)
            with spans.span("inner"):
                spans.count("n", 5)
                spans.count("m")
            spans.count("n")
    outer, inner = rec.spans
    assert outer.counts == {"n": 3} and inner.counts == {"n": 5, "m": 1}


def test_device_spans_take_events_read_at_the_end(fake_card):
    with spans.recording() as rec:
        with spans.span("timed", CUDA):
            with spans.span("host"):
                pass
        assert rec.spans[0].device_ms is None  # read when the recording ends
    timed, host = rec.spans
    assert len(fake_card) == 2 and not any(e.external for e in fake_card)
    assert timed.device_ms == 1.0 and timed._events is None and host.device_ms is None


def test_a_captures_phases_are_entered_at_each_replay(fake_card):
    """Spans entered while a capture collects are the graph's phases, not
    spans of the recording; each replay enters them, with their device
    times, under the span open at the replay.  With nothing recording at
    the capture the graph has no phase to enter."""
    with spans.recording() as rec:
        with spans.span("capture"), spans.graph_phases() as phases:
            with spans.span("p1", CUDA, part=1):
                pass
            with spans.span("p2", CUDA):
                pass
            with spans.span("untimed"):
                pass
        assert [s.name for s in rec.spans] == ["capture"]
        assert [p.name for p in phases] == ["p1", "p2"]
        assert all(e.external for e in fake_card) and len(fake_card) == 4
        for _ in range(2):
            with spans.span("step"):
                spans.replayed(phases)
    names = [s.name for s in rec.spans]
    assert names == ["capture", "step", "p1", "p2", "step", "p1", "p2"]
    steps = rec.named("step")
    for s in rec.named("p1") + rec.named("p2"):
        assert s.parent in steps and s.call == s.parent.call and s.ms is None
        assert s.device_ms == 1.0
    assert rec.named("p1")[0].attrs == {"part": 1}
    with spans.graph_phases() as unrecorded, spans.span("p1", CUDA):
        pass
    assert unrecorded == [] and len(fake_card) == 4


def test_profiled_spans_are_record_function_ranges_on_the_profilers_clock():
    """Each span is a ``record_function`` range of its name in the
    profile, and its host stamps, converted to the epoch clock, lie within
    1 ms of the range's (``perf_counter`` is not the profiler's clock).  A
    process's first range takes ~1 ms to enter, so a first span warms up."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof, spans.recording() as rec:
        with spans.span("warm"):
            pass
        with spans.span("spans.outer"):
            torch.ones(64).sum()
            with spans.span("spans.inner"):
                torch.ones(64).cumsum(0)
    events = {e.name(): e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("spans.")}
    assert set(events) == {"spans.outer", "spans.inner"}
    for s in rec.spans[1:]:
        e = events[s.name]
        assert abs(rec.epoch_ns(s.t0) - e.start_ns()) < 1e6
        assert abs(rec.epoch_ns(s.t1) - (e.start_ns() + e.duration_ns())) < 1e6


def test_serve_records_its_call_and_a_token_a_step():
    """One ``serve.call`` holds the prefill, the prefill step's release,
    the decode capture, gen - 1 tokens (each the step's call, then the
    host's read) and the decode step's release; ``record`` is read from
    those spans, and keeps no logits unless asked."""
    record = {}
    with spans.recording() as rec:
        _serve(record=record)
    (call,) = rec.named("serve.call")
    assert call.parent is None and call.attrs["gen"] == GEN
    children = [s.name for s in rec.spans if s.parent is call]
    assert children == (["serve.prefill", "serve.release", "serve.decode_capture"]
                        + ["serve.token"] * (GEN - 1) + ["serve.release"])
    assert all(s.call == call.call for s in rec.spans)
    prefill = rec.named("serve.prefill")[0]
    assert [s.name for s in rec.spans if s.parent is prefill] == ["prefill.layers",
                                                                  "prefill.logits"]
    tokens = rec.named("serve.token")
    assert [[c.name for c in rec.spans if c.parent is t] for t in tokens] == [
        ["serve.step"]] * (GEN - 1)
    assert not rec.named("graph.capture") and call.counts == {}
    assert record["prefill_ms"] == prefill.ms
    assert record["capture_ms"] == rec.named("serve.decode_capture")[0].ms
    assert record["prefill_capture_ms"] == 0.0
    dt_ms = (tokens[-1].t1 - tokens[0].t0) / 1e6
    assert record["decode_ms_per_token"] == pytest.approx(dt_ms / (GEN - 1), rel=1e-12)
    assert record["tokens_per_s"] == pytest.approx(B * (GEN - 1) / dt_ms * 1e3, rel=1e-12)
    assert "logits" not in record


def test_keep_logits_asks_for_the_logits():
    record = {}
    toks = _serve(record=record, keep_logits=True)
    assert len(record["logits"]) == GEN
    np.testing.assert_array_equal(record["logits"][-1].argmax(-1).numpy(), toks[:, -1])
    with pytest.raises(ValueError, match="keep_logits"):
        _serve(keep_logits=True)


def _train_arch(host: bool):
    arch = get_config("starcoder2-3b")
    arch = dataclasses.replace(arch, model=arch.model.reduce())
    plan = (ResidencyPlan(arch.name, "t", MeshConfig(), MemoryBudget(),
                          opt_space=MemorySpace.HOST, int8_moments=True,
                          remat=arch.train.remat) if host else None)
    return arch, plan


def _train_parts(arch, plan, S=16):
    model = tt.init_params(arch.model, torch.Generator().manual_seed(0), "cpu")
    state = tadamw.init_state(model, tstep._adamw_cfg(arch, plan))
    step = tstep.build_train_step(arch, ShapeConfig("t", S, B, "train"), None, plan,
                                  total_steps=10, device="cpu")
    toks = torch.randint(0, arch.model.vocab_size, (B, S), generator=torch.Generator()
                         .manual_seed(1), dtype=torch.int32)
    return model, state, step, {"tokens": toks, "labels": toks.roll(-1, 1)}


@pytest.mark.parametrize("host", [False, True], ids=["card_plan", "host_plan"])
def test_a_train_step_records_its_phases(host):
    """Each ``train.step`` holds the body's phases in order: the gradients,
    the clip and the update, with the host plan's fetch before the update
    and its offload after."""
    arch, plan = _train_arch(host)
    model, state, step, batch = _train_parts(arch, plan)
    with spans.recording() as rec:
        for n in (1, 2):
            step(model, state, batch, n)
    want = (["train.grads", "train.clip", "train.fetch", "train.update", "train.offload"]
            if host else ["train.grads", "train.clip", "train.update"])
    steps = rec.named("train.step")
    assert len(steps) == 2 and [s.call for s in steps] == [1, 2]
    for s in steps:
        assert [c.name for c in rec.spans if c.parent is s] == want
        assert all(c.ms <= s.ms for c in rec.spans if c.parent is s)


class _Ev:
    """A kineto event as ``idle_by_span`` reads it."""

    def __init__(self, name, a, b, card=False, annotation=False):
        self._n, self._a, self._b, self._card, self._ann = name, a, b, card, annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._a

    def duration_ns(self):
        return self._b - self._a

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._card else torch.autograd.DeviceType.CPU

    def is_user_annotation(self):
        return self._ann


def test_idle_by_span_gives_each_idle_instant_to_the_innermost_span():
    """Host ranges: call [0, 100] holding capture [10, 40] and its warmup
    [12, 20], release [60, 80]; kernels at [0, 11], [15, 18], [30, 65],
    [90, 95] and one past the call; a card-side annotation and an
    unrelated host op are no work and no span."""
    ms = 1_000_000
    ev = [_Ev("serve.call", 0, 100 * ms), _Ev("graph.capture", 10 * ms, 40 * ms),
          _Ev("graph.warmup", 12 * ms, 20 * ms), _Ev("serve.release", 60 * ms, 80 * ms),
          _Ev("cudaFree", 61 * ms, 70 * ms)]
    ev += [_Ev("k", a * ms, b * ms, card=True) for a, b in
           ((0, 11), (15, 18), (30, 65), (90, 95), (120, 130))]
    ev.append(_Ev("serve.call", 0, 100 * ms, card=True, annotation=True))
    got = spans.idle_by_span(ev, {"serve.call", "graph.capture", "graph.warmup",
                                  "serve.release"})
    # idle: [11, 15] -> capture 1 (11-12), warmup 3 (12-15); [18, 30] -> warmup 2
    # (18-20), capture 10; [65, 90] -> release 15 (65-80), call 10; [95, 100] -> call 5
    assert got == pytest.approx({"serve.call": 15.0, "graph.capture": 11.0,
                                 "graph.warmup": 5.0, "serve.release": 15.0})
    assert spans.idle_by_span(ev, {"nothing"}) == {}
