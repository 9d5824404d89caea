"""Tokens of every step completed in the window, over the whole window."""
LAYER, UNIT, SOURCE = None, "tokens/s", "host_clock"


def read(facts):
    if facts["kind"] != "train":
        return None
    return facts["trained_tokens"] / facts["window_s"]
