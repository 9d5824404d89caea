"""One call or step under ``torch.profiler``, reduced to what the per-layer
metrics read: the window, the union of the device's busy intervals
(kernels, copies and fills), the GEMM kernels' and the host<->device
copies' device time, every operation's device time and count by name,
the operations that took most time and the longest idle gaps, each named by
the host operation that was running.  And one call or step inside the
program's ``spans.recording()``, with no profiler, reduced to its spans'
times and counters' totals by name (``recorded``)."""
from __future__ import annotations

import re

import torch

WINDOW = "perfbench.window"
GEMM_KERNEL = re.compile(r"gemm|nvjet|cutlass|xmma", re.IGNORECASE)
HOST_COPY = re.compile(r"Memcpy (HtoD|DtoH)")
TOP = 10
NAME_CHARS = 160


def profiled(fn, device) -> dict:
    """Runs ``fn()`` once under the profiler, the device synchronised
    before and after, and reduces its trace (``reduce``)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(WINDOW):
            fn()
            torch.cuda.synchronize(device)
    return reduce(prof.profiler.kineto_results.events())


def reduce(events) -> dict:
    """``events``: the profiler's kineto events (``name()``,
    ``device_type()``, ``start_ns()``, ``duration_ns()``,
    ``is_user_annotation()``); names cut to ``NAME_CHARS``."""
    cuda = torch.autograd.DeviceType.CUDA
    device, host, window = [], [], None
    for e in events:
        span = (e.start_ns(), e.start_ns() + e.duration_ns(), e.name()[:NAME_CHARS])
        on_card = e.device_type() == cuda
        if e.name() == WINDOW:
            if not on_card:
                window = span
        elif not on_card:
            host.append(span)
        elif not e.is_user_annotation():  # an annotation's span on the card is no work
            device.append(span)
    if window is None or not device:
        raise RuntimeError("the profiler recorded no window or no device operation")
    lo, hi = window[0], window[1]
    device = [(max(a, lo), min(b, hi), n) for a, b, n in device if b > lo and a < hi]
    busy, gaps, end = 0, [], lo
    for a, b, _ in sorted(device):
        if a > end:
            gaps.append((end, a))
        if b > end:
            busy += b - max(a, end)
            end = b
    if hi > end:
        gaps.append((end, hi))
    by_name: dict[str, int] = {}
    count: dict[str, int] = {}
    for a, b, n in device:
        by_name[n] = by_name.get(n, 0) + b - a
        count[n] = count.get(n, 0) + 1
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    return {
        "window_s": (hi - lo) / 1e9,
        "busy_s": busy / 1e9,
        "gemm_s": sum(b - a for a, b, n in device if GEMM_KERNEL.search(n)) / 1e9,
        "host_copy_s": sum(b - a for a, b, n in device if HOST_COPY.search(n)) / 1e9,
        "kernel_s": {n: t / 1e9 for n, t in by_name.items()},
        "kernel_n": count,
        "device_ops": [[n, t / 1e9] for n, t in
                       sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]],
        "idle_gaps": [[_host_at((a + b) // 2, host), (b - a) / 1e9] for a, b in longest],
    }


def _host_at(t: int, host: list) -> str:
    """The innermost host operation running at ``t``."""
    best = None
    for a, b, n in host:
        if a <= t <= b and (best is None or b - a < best[1] - best[0]):
            best = (a, b, n)
    return f"host: {best[2]}" if best else "host: between operations"


def recorded(fn) -> dict:
    """Runs ``fn()`` once inside the program's ``spans.recording()`` (no
    profiler: the spans' device times are CUDA events) and reduces what it
    kept (``summary``)."""
    from repro_torch import spans

    with spans.recording() as rec:
        fn()
    return summary(rec.spans)


def summary(kept) -> dict:
    """``by_name``: for each span name its ``count``, the host ms of each
    (a graph's phase has none) and the device ms of each device-timed one;
    ``counters``: each counter's total over the spans."""
    by_name, counters = {}, {}
    for s in kept:
        entry = by_name.setdefault(s.name, {"count": 0, "host_ms": [], "device_ms": []})
        entry["count"] += 1
        if s.ms is not None:
            entry["host_ms"].append(s.ms)
        if s.device_ms is not None:
            entry["device_ms"].append(s.device_ms)
        for name, n in s.counts.items():
            counters[name] = counters.get(name, 0) + n
    return {"by_name": by_name, "counters": counters}


def describe(reduced: dict) -> str:
    """One line of a ``summary``: each span's count and median host and
    device ms ("-" for none), then the counters."""
    from perfbench.stats import median

    def ms(values):
        return f"{median(values):.3f}" if values else "-"

    spans = " ".join(f"{n}/{e['count']}/{ms(e['host_ms'])}/{ms(e['device_ms'])}"
                     for n, e in reduced["by_name"].items())
    return f"spans (count/host ms/device ms): {spans}; counters: {reduced['counters']}"
