"""The whole call's share of the card's peak: the calls' least time (the
prefill's FLOPs at the bf16 peak and the decode steps' bytes at the
memory rate, ``bounds.serve_call_bound_s``) over the window's time."""
LAYER, UNIT, SOURCE = "models (whole call)", "%", "host_clock"


def read(facts):
    if facts["kind"] != "serve":
        return None
    return 100.0 * facts["calls"] * facts["call_bound_s"] / facts["window_s"]
