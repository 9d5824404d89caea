"""The whole call's share of the card's peak: the calls' least time (each
call's prefill FLOPs at the bf16 peak and its decode steps' bytes at the
memory rate, ``bounds.serve_call_bound_s``, summed over the calls) over the
window's time."""
import math

LAYER, UNIT, SOURCE = "models (whole call)", "%", "host_clock"


def read(facts):
    if facts["kind"] != "serve":
        return None
    return 100.0 * math.fsum(facts["call_bound_s"]) / facts["window_s"]
