"""Tour of the three advises x two platform classes — the paper's central
cross-platform asymmetry through the port's UM simulator — then of the
remote-tier family on grace-hopper-c2c: as the hot (re-read every pass)
share of the working set grows, migrate-everything (um) overtakes
remote-everything (svm_remote / um_pinned_zero_copy), and the
access-counter hybrid tracks the better of the two by promoting exactly
the chunks that prove hot.  The counterpart of ``examples/um_advise_tour.py``;
the simulator runs on the host and needs no card.

    PYTHONPATH=src python -m repro_torch.examples.um_advise_tour
"""
from __future__ import annotations

import argparse

from repro_torch.core import GB, MB, UMSimulator
from repro_torch.core.advise import Accessor, MemorySpace
from repro_torch.umbench.platforms import GRACE_HOPPER, INTEL_VOLTA, P9_VOLTA
from repro_torch.umbench.variants import get_strategy
from repro_torch.umbench.workload import WorkloadBuilder

SIZE = int(12 * GB)
POLICIES = ("read_mostly", "preferred+accessed_by")
TIERS = ("um", "svm_remote", "um_pinned_zero_copy", "um_hybrid_counters")
TOTAL = int(0.8 * GRACE_HOPPER.device_mem_gb * GB)   # in-memory regime
HOT_FRACS = (0.05, 0.25, 0.50, 0.75, 0.95)


def run(platform, policy: str, oversub: bool) -> float:
    sim = UMSimulator(platform)
    n = int(SIZE * (1.5 if oversub else 0.8)) // 2
    sim.alloc("A", n, role="input")
    sim.alloc("B", n, role="output")
    if policy == "preferred+accessed_by":
        sim.advise_preferred_location("A", MemorySpace.DEVICE)
        sim.advise_accessed_by("A", Accessor.HOST)
    sim.host_write("A")
    if policy == "read_mostly":
        sim.advise_read_mostly("A")
    for _ in range(4):
        sim.kernel("k", flops=1e12, reads=["A"], writes=["B"])
    sim.host_read("B")
    return sim.finish().total_s


def hotcold_workload(total: int, hot_frac: float, iters: int = 6):
    """A working set with an explicitly split temperature: the hot region
    is re-read on every pass, the cold region is streamed through exactly
    once across all passes (a rotating 1/iters slice per kernel)."""
    hot = max(int(total * hot_frac), 64 * MB)
    cold = max(total - hot, 64 * MB)
    w = WorkloadBuilder("hotcold")
    w.alloc("hot", hot, role="input").host_write("hot")
    w.alloc("cold", cold, role="input").host_write("cold")
    w.alloc("out", 64 * MB, role="output")
    for i in range(iters):
        w.kernel(f"pass{i}", flops=1e12, reads=("hot", "cold"),
                 writes=("out",), partial={"cold": 1.0 / iters})
    w.readback("out")
    return w.build()


def run_tier(workload, variant: str) -> float:
    sim = UMSimulator(GRACE_HOPPER)
    get_strategy(variant).lower(workload, sim)
    return sim.finish().total_s


def main(argv=None) -> dict:
    """Print the tour; return {"speedups": {(regime, platform, policy): x},
    "tiers": {hot_frac: {variant: total_s}}}."""
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    speedups = {}
    for oversub in (False, True):
        regime = "oversubscribed" if oversub else "in-memory   "
        print(f"--- {regime} ---")
        for platform in (INTEL_VOLTA, P9_VOLTA):
            base = run(platform, "none", oversub)
            for policy in POLICIES:
                x = speedups[(regime.strip(), platform.name, policy)] = \
                    base / run(platform, policy, oversub)
                print(f"  {platform.name:18s} {policy:22s} "
                      f"{x:5.2f}x vs basic UM")

    print(f"\n--- remote-tier family on {GRACE_HOPPER.name} "
          f"(total_s as the hot working set grows) ---")
    print("  hot_frac  " + "".join(f"{v:>21s}" for v in TIERS))
    tiers = {}
    for hot_frac in HOT_FRACS:
        wl = hotcold_workload(TOTAL, hot_frac)
        times = tiers[hot_frac] = {v: run_tier(wl, v) for v in TIERS}
        best = min(times, key=times.get)
        cells = "".join(
            f"{times[v]:>20.3f}{'*' if v == best else ' '}" for v in TIERS)
        print(f"  {hot_frac:8.2f}{cells}")
    print("  (* = fastest; um wins once the hot share dominates, the remote"
          "\n   tiers win while it is small, and the counter hybrid migrates"
          "\n   only what crossed its touch threshold, tracking the winner)")
    return {"speedups": speedups, "tiers": tiers}


if __name__ == "__main__":
    main()
