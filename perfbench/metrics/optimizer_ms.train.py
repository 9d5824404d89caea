"""The optimizer alone: the clip and ``apply_updates`` on fresh
gradients, eager, timed by CUDA events after the window (median of 3)."""
LAYER, UNIT, SOURCE = "optim", "ms", "program_span"


def read(facts):
    if facts["kind"] != "train":
        return None
    return facts.get("optimizer_ms")
