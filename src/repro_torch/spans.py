"""Spans and counters inside the port: where a serve call's or a train
step's time goes, taken where the work happens.

    from repro_torch import spans

    with spans.recording() as rec:
        serve("qwen2-7b", ...)
    for s in rec.named("serve.token"):
        s.ms, s.parent.name, s.call

``span(name, device=None, **attrs)`` is the context manager the program's
layers open around their work.  It always reads the host clock at its entry
and exit (``ms``), and while nothing records that is all it does: no CUDA
event, no ``record_function``, no synchronisation.  While a ``recording()``
is open a span also keeps its parent (the innermost span open at its
entry), the call id of its root, its attrs and the counters ``count`` adds
while it is the innermost; with ``device`` a CUDA device, a pair of timing
events on that device's current stream, read when the recording ends
(``device_ms``: the stream's time from the entry to the exit, idle included);
and while ``torch.profiler`` profiles, a ``record_function`` range of its
name, so the profile carries the program's spans (``idle_by_span``).

Spans inside a CUDA graph.  A span entered during a capture, inside
``graph_phases()``, is a phase of the graph and not a span of the
recording: its events are recorded with ``external=True``, so they become
event-record nodes that every replay records again, and ``replayed(phases)``
after a replay enters each phase as a span with ``device_ms`` alone (no host
stamps: the host only launched the graph), before the next replay rewrites
the events.  With nothing recording at the capture the graph captures no
phase and is the graph it would be without spans.

Host stamps are ``time.perf_counter_ns()``; ``Recording.epoch_ns`` converts
them to the Unix-epoch nanoseconds of the profiler's events through one
offset taken as the recording opens.  A recording is held in a context
variable: it sees the spans of its own thread only.
"""
from __future__ import annotations

import contextlib
import time
from contextvars import ContextVar

import torch

_ACTIVE: ContextVar[Recording | None] = ContextVar("repro_torch_spans", default=None)


def _on_card(device) -> bool:
    return getattr(device, "type", None) == "cuda"


def _event_pair(device, external: bool) -> tuple:
    stream = torch.cuda.current_stream(device)
    pair = (torch.cuda.Event(enable_timing=True, external=external),
            torch.cuda.Event(enable_timing=True, external=external))
    pair[0].record(stream)
    return pair


class span:
    """One span: ``with span("serve.token", device=dev) as s: ...``; ``s.ms``
    is its host duration afterwards, recorded or not."""

    parent = call = counts = device_ms = None
    _rec = _events = _range = None
    _phase = False

    def __init__(self, name: str, device=None, **attrs):
        self.name, self.device, self.attrs = name, device, attrs
        self.t0 = self.t1 = None

    def __enter__(self):
        rec = _ACTIVE.get()
        if rec is not None:
            rec._open(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        if self._rec is not None:
            self._rec._close(self)
        return False

    @property
    def ms(self) -> float | None:
        """Host milliseconds from the entry to the exit (None for a graph's
        phase, which has no host stamps)."""
        return None if self.t0 is None else (self.t1 - self.t0) / 1e6

    def __repr__(self) -> str:
        return f"span({self.name!r}, call={self.call}, attrs={self.attrs})"


class Recording:
    """What one ``recording()`` kept: ``spans`` in the order they were
    entered (a graph's phases when they were replayed)."""

    def __init__(self):
        self.spans: list[span] = []
        self.offset_ns = time.time_ns() - time.perf_counter_ns()
        self._stack: list[span] = []
        self._pending: list[span] = []
        self._phases: list[span] | None = None
        self._calls = 0

    def named(self, name: str) -> list[span]:
        return [s for s in self.spans if s.name == name]

    def epoch_ns(self, t: int) -> int:
        """A host stamp of ``time.perf_counter_ns()`` in Unix-epoch ns, the
        clock of the profiler's events."""
        return t + self.offset_ns

    def _keep(self, s: span) -> None:
        s.parent = self._stack[-1] if self._stack else None
        if s.parent is None:
            self._calls += 1
            s.call = self._calls
        else:
            s.call = s.parent.call
        s.counts = {}
        self.spans.append(s)

    def _open(self, s: span) -> None:
        s._rec = self
        if self._phases is not None:
            s._phase = True
            if _on_card(s.device):
                s._events = _event_pair(s.device, external=True)
            return
        self._keep(s)
        self._stack.append(s)
        if torch._C._autograd._profiler_enabled():
            s._range = torch.autograd.profiler.record_function(s.name)
            s._range.__enter__()
        if _on_card(s.device):
            s._events = _event_pair(s.device, external=False)

    def _close(self, s: span) -> None:
        s._rec = None  # no cycle through the recording
        if s._events is not None:
            s._events[1].record(torch.cuda.current_stream(s.device))
        if s._phase:
            if s._events is not None:
                self._phases.append(s)
            return
        if s._range is not None:
            s._range.__exit__(None, None, None)
            s._range = None
        self._stack.remove(s)
        if s._events is not None:
            self._pending.append(s)

    def _resolve(self) -> None:
        for s in self._pending:
            s._events[1].synchronize()
            s.device_ms = s._events[0].elapsed_time(s._events[1])
            s._events = None
        self._pending = []


def active() -> Recording | None:
    """The open recording, or None."""
    return _ACTIVE.get()


def count(name: str, n: int = 1) -> None:
    """Adds ``n`` to counter ``name`` of the innermost open span; nothing
    while nothing records or no span is open."""
    rec = _ACTIVE.get()
    if rec is None or not rec._stack:
        return
    counts = rec._stack[-1].counts
    counts[name] = counts.get(name, 0) + n


@contextlib.contextmanager
def recording():
    """Records the spans and counters of this thread until the block ends,
    then reads their device times; yields the ``Recording``."""
    rec = Recording()
    token = _ACTIVE.set(rec)
    try:
        yield rec
    finally:
        _ACTIVE.reset(token)
    rec._resolve()


@contextlib.contextmanager
def graph_phases():
    """Around a graph's capture: yields the list of the device-timed spans
    captured in it (empty while nothing records), for ``replayed``."""
    phases: list[span] = []
    rec = _ACTIVE.get()
    if rec is None:
        yield phases
        return
    outer, rec._phases = rec._phases, phases
    try:
        yield phases
    finally:
        rec._phases = outer


def replayed(phases: list[span]) -> None:
    """After a replay of the graph whose capture gave ``phases``: waits for
    its last phase and enters each as a span of the open recording, its
    ``device_ms`` this replay's.  Nothing while nothing records."""
    rec = _ACTIVE.get()
    if rec is None or not phases:
        return
    phases[-1]._events[1].synchronize()
    for p in phases:
        s = span(p.name, p.device, **p.attrs)
        rec._keep(s)
        s.device_ms = p._events[0].elapsed_time(p._events[1])


def _union(intervals: list) -> list:
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def idle_by_span(events, names) -> dict[str, float]:
    """Milliseconds the card was idle inside the program's spans, by span
    name, each idle instant given to the innermost span open at it.

    ``events``: a profile's kineto events (``prof.profiler.kineto_results
    .events()``) of a run recorded while profiled, so that each span is a
    host ``record_function`` range; ``names``: the span names to count
    (those of the recording).  The card is busy where a kernel, copy or fill
    runs (the device side of an annotation is no work)."""
    cuda = torch.autograd.DeviceType.CUDA
    busy, ranges = [], []
    for e in events:
        a, b = e.start_ns(), e.start_ns() + e.duration_ns()
        if e.device_type() == cuda:
            if not e.is_user_annotation():
                busy.append((a, b))
        elif e.name() in names:
            ranges.append((a, b, e.name()))
    out = {n: 0.0 for n in sorted({n for _, _, n in ranges})}
    if not ranges:
        return out
    lo, hi = min(a for a, _, _ in ranges), max(b for _, b, _ in ranges)
    gaps, end = [], lo
    for a, b in _union(busy):
        if a > end:
            gaps.append((end, min(a, hi)))
        end = max(end, b)
        if end >= hi:
            break
    if end < hi:
        gaps.append((end, hi))
    marks = sorted([(a, 1, i) for i, (a, _, _) in enumerate(ranges)]
                   + [(b, 0, i) for i, (_, b, _) in enumerate(ranges)])
    stack: list[int] = []
    k = 0

    def step(upto):
        nonlocal k
        while k < len(marks) and marks[k][0] <= upto:
            _, opens, i = marks[k]
            if opens:
                stack.append(i)
            else:
                stack.remove(i)
            k += 1

    def give(a, b):
        if stack and b > a:
            out[ranges[stack[-1]][2]] += (b - a) / 1e6

    for g0, g1 in gaps:
        step(g0)
        cur = g0
        while k < len(marks) and marks[k][0] < g1:
            give(cur, marks[k][0])
            cur = marks[k][0]
            step(cur)
        give(cur, g1)
    return out


__all__ = ["Recording", "active", "count", "graph_phases", "idle_by_span", "recording",
           "replayed", "span"]
