"""One call or step under ``torch.profiler``, reduced to what the per-layer
metrics read: the window, the union of the device's busy intervals
(kernels, copies and fills), the GEMM kernels' and the host<->device
copies' device time, the operations that took most time and the longest
idle gaps, each named by the host operation that was running."""
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
    for a, b, n in device:
        by_name[n] = by_name.get(n, 0) + b - a
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    return {
        "window_s": (hi - lo) / 1e9,
        "busy_s": busy / 1e9,
        "gemm_s": sum(b - a for a, b, n in device if GEMM_KERNEL.search(n)) / 1e9,
        "host_copy_s": sum(b - a for a, b, n in device if HOST_COPY.search(n)) / 1e9,
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
