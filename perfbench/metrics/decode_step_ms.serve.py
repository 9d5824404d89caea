"""One decode step's time on the card: the median over the recorded
call's steps of the program's ``serve.step`` span (the step's input fill
and graph replay, timed by CUDA events on the serving stream, idle
included).  That call, of the round's median shape, runs before the
profiler, which leaves later calls slower than the window's.  The host's
share of a token's gap is the rest of it."""
from perfbench.stats import median

LAYER, UNIT, SOURCE = "launch.step (graph builders)", "ms", "program_span"


def read(facts):
    spans = facts.get("spans")
    if facts["kind"] != "serve" or spans is None:
        return None
    step = spans["by_name"].get("serve.step")
    if step is None or not step["device_ms"]:
        return None
    return median(step["device_ms"])
