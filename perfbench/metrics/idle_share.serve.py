"""The share of one profiled call in which no kernel, copy or fill ran on
the card."""
LAYER, UNIT, SOURCE = "device", "%", "device_trace"


def read(facts):
    t = facts.get("trace")
    if facts["kind"] != "serve" or t is None:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
