"""Serving-tier demo (DESIGN.md §13): one short Poisson trace of LM
inference requests, continuous-batched over the UM simulator with the KV
cache as UM regions, across four memory tiers and two KV regimes — watch
which tier keeps tail latency flat once the aggregate KV oversubscribes
device memory.  The counterpart of ``examples/kv_serving_demo.py``; the
simulator runs on the host and needs no card.

    PYTHONPATH=src python -m repro_torch.examples.kv_serving_demo
"""
from __future__ import annotations

import argparse

from repro_torch.umbench.serving import get_pattern, run_serving_cell

TIERS = ("um", "um_prefetch_pipelined", "um_hybrid_counters",
         "um_pinned_zero_copy")
PLATFORM = "p9-volta-nvlink"
REGIMES = ("kv_100", "kv_200")


def main(argv=None) -> dict:
    """Print the demo; return {regime: {tier: ServingReport or None}}."""
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    pat = get_pattern("poisson")
    print(f"trace: {pat.n_requests} requests, ~{pat.rate_rps:.0f} rps poisson, "
          f"prompt~{pat.prompt_mean} gen~{pat.gen_mean} tokens, on {PLATFORM}")
    reports = {}
    for regime in REGIMES:
        print(f"\n--- {regime} "
              f"({'at-capacity' if regime == 'kv_100' else '2x KV oversub'}) ---")
        print(f"  {'tier':22s} {'ttft_p99':>9s} {'e2e_p99':>9s} "
              f"{'goodput':>8s} {'evictions':>10s}")
        for tier in TIERS:
            r = reports.setdefault(regime, {})[tier] = run_serving_cell(
                "poisson", tier, PLATFORM, regime).report
            if r is None:
                print(f"  {tier:22s} {'N/A':>9s}")
                continue
            print(f"  {tier:22s} {r.ttft_p99_s:8.3f}s {r.e2e_p99_s:8.3f}s "
                  f"{r.goodput_rps:7.2f}r {r.sim.n_evictions:>10d}")
    print("\n(TTFT/e2e are simulated stream-clock seconds; the remote tiers "
          "dodge\n eviction churn entirely, the counter hybrid migrates only "
          "proven-hot\n KV blocks, and plain UM pays the full thrash.)")
    return reports


if __name__ == "__main__":
    main()
