"""The paged attention kernels' share of their memory roofline in the
profiled call: the bytes of the decode steps the trace ran, at the HBM
rate, over the device time of every kernel of the port's paged attention
(the split-KV work items, their merge, the CUDA-core kernel).  The steps
are counted from the trace, one launch of the work-item or the CUDA-core
kernel a layer a step: the call's gen - 1 steps from its prompt length on
(``bounds.paged_decode_bytes``), and any more before them (the decode
capture's warm-ups) at the first step's length (``bounds.paged_step_bytes``).
Live rows only: a lower bound."""
import re

from perfbench.bounds import PEAK_BYTES_PER_S, paged_decode_bytes, paged_step_bytes

LAYER, UNIT, SOURCE = "kernels (paged_attention)", "%", "device_trace"
KERNEL = re.compile(r"paged_(tc|merge|decode)_kernel")
STEP_KERNEL = re.compile(r"paged_(tc|decode)_kernel")  # one launch a layer a step


def read(facts):
    t, call, m = facts.get("trace"), facts.get("traced_call"), facts.get("spec")
    if facts["kind"] != "serve" or t is None or call is None:
        return None
    seconds = sum(s for name, s in t["kernel_s"].items() if KERNEL.search(name))
    launches = sum(n for name, n in t["kernel_n"].items() if STEP_KERNEL.search(name))
    steps, rest = divmod(launches, m.layers)
    extra = steps - (call["gen"] - 1)
    if seconds <= 0 or steps == 0 or rest or extra < 0:
        return None
    B, P = call["batch"], call["prompt_len"]
    moved = paged_decode_bytes(m, B, P, call["gen"]) + extra * paged_step_bytes(m, B, P)
    return 100.0 * moved / PEAK_BYTES_PER_S / seconds
