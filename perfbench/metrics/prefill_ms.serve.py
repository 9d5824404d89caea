"""The median over the window's calls of ``serve()``'s ``prefill_ms``: the
cold prefill call, its capture and the caches' re-homing."""
from perfbench.stats import median

LAYER, UNIT, SOURCE = "launch.serve (entry)", "ms", "program_span"


def read(facts):
    if facts["kind"] != "serve":
        return None
    return median(facts["prefill_ms"])
