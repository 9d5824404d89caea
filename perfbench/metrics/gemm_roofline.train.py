"""The GEMM kernels' share of their roofline in one profiled step: the
step's FLOPs (``bounds.train_step_flops``: every one of them is a GEMM's)
at the bf16 peak over the device time of the kernels whose names are
GEMMs'.  Remat's recomputed products take GEMM time and are not counted."""
from perfbench.bounds import PEAK_BF16_FLOPS

LAYER, UNIT, SOURCE = "kernels (cuBLAS)", "%", "device_trace"


def read(facts):
    t = facts.get("trace")
    if facts["kind"] != "train" or t is None or t["gemm_s"] <= 0:
        return None
    return 100.0 * facts["step_flops"] / PEAK_BF16_FLOPS / t["gemm_s"]
