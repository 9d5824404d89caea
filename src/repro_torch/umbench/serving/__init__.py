"""Serving tier (DESIGN.md §13): continuous-batching LM inference with a
UM-managed KV cache, driven through the UM simulator.  The port's copy of
``repro.umbench.serving``: NumPy and the standard library on the host, like
the rest of the sweep engine; it takes no device and creates no tensor.

``traffic``    seeded request-arrival generators (poisson/bursty/diurnal)
``scheduler``  the saxml-style continuous-batching loop; KV blocks are UM
               regions allocated/freed with request lifetimes
``metrics``    per-request TTFT / end-to-end latency -> p50/p95/p99 + goodput
``sweep``      journaled, resumable serving cells over the variant registry
"""
from repro_torch.umbench.serving.metrics import ServingReport, percentile, summarize
from repro_torch.umbench.serving.scheduler import (
    ContinuousBatchScheduler,
    ServedRequest,
    ServingConfig,
    serve,
)
from repro_torch.umbench.serving.sweep import (
    SERVING_REGIMES,
    ServingCellResult,
    run_serving_cell,
    run_serving_specs,
    serving_specs,
)
from repro_torch.umbench.serving.traffic import (
    PATTERNS,
    Request,
    TrafficPattern,
    get_pattern,
    pattern_names,
)

__all__ = [
    "PATTERNS",
    "SERVING_REGIMES",
    "ContinuousBatchScheduler",
    "Request",
    "ServedRequest",
    "ServingCellResult",
    "ServingConfig",
    "ServingReport",
    "TrafficPattern",
    "get_pattern",
    "pattern_names",
    "percentile",
    "run_serving_cell",
    "run_serving_specs",
    "serve",
    "serving_specs",
    "summarize",
]
