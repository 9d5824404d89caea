"""The 95th percentile of every gap between successive tokens of a call in
the window, taken over all the gaps together (a call's first gap holds
its decode capture)."""
from perfbench.stats import percentile

LAYER, UNIT, SOURCE = None, "ms", "host_clock"


def read(facts):
    if facts["kind"] != "serve" or not facts["gaps_ms"]:
        return None
    return percentile(facts["gaps_ms"], 95)
