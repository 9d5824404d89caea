"""The whole step's share of the card's bf16 peak: the step's FLOPs
(``bounds.train_step_flops``) a step, over the window's time a step."""
from perfbench.bounds import PEAK_BF16_FLOPS

LAYER, UNIT, SOURCE = "models (whole step)", "%", "host_clock"


def read(facts):
    if facts["kind"] != "train":
        return None
    return 100.0 * facts["steps"] * facts["step_flops"] / PEAK_BF16_FLOPS / facts["window_s"]
