"""The device time of host<->device copies in one profiled step: the host
plan's fetch and offload of the optimizer state (about nothing with the
state on the card)."""
LAYER, UNIT, SOURCE = "core.streaming (movement)", "ms", "device_trace"


def read(facts):
    t = facts.get("trace")
    if facts["kind"] != "train" or t is None:
        return None
    return 1e3 * t["host_copy_s"]
