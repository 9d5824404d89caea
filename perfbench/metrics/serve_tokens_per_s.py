"""Generated tokens of every call completed in the window, over the whole
window: prefills and captures included."""
LAYER, UNIT, SOURCE = None, "tokens/s", "host_clock"


def read(facts):
    if facts["kind"] != "serve":
        return None
    return facts["generated"] / facts["window_s"]
