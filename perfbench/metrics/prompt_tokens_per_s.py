"""Prompt tokens of every call completed in the window, over the whole
window: what a caller who sends long documents for short answers gets."""
LAYER, UNIT, SOURCE = None, "tokens/s", "host_clock"


def read(facts):
    if facts["kind"] != "serve":
        return None
    return facts["prompt_tokens"] / facts["window_s"]
