"""The median over the window's calls of the two captures a call makes:
``serve()``'s ``prefill_capture_ms`` plus its ``capture_ms``."""
from perfbench.stats import median

LAYER, UNIT, SOURCE = "launch.step (graph builders)", "ms", "program_span"


def read(facts):
    if facts["kind"] != "serve":
        return None
    return median(facts["capture_ms"])
