"""Quickstart: the paper's three UM features through the port's public API,
the counterpart of ``examples/quickstart.py``.

    PYTHONPATH=src python -m repro_torch.examples.quickstart \
        [--device cpu --hbm-bytes N]

1. Memory advises on two simulated UM platforms (the UM simulator).
2. Residency planning for starcoder2-3b and grok-1-314b / train_4k against
   the card's memory a device, or ``--hbm-bytes``.
3. The Black-Scholes kernel on 8 options: the CUDA kernel on the card, its
   plain version on the CPU.

On the CPU there is no card's memory to plan against: ``--hbm-bytes``
gives it.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import MeshConfig, get_config, get_shape
from repro_torch.core import UMSimulator, plan_cell
from repro_torch.device import resolve
from repro_torch.kernels import black_scholes
from repro_torch.umbench.platforms import INTEL_PASCAL, P9_VOLTA

ARCHS = ("starcoder2-3b", "grok-1-314b")


def banner(title: str) -> None:
    print("=" * 70)
    print(title)
    print("=" * 70)


def advise_comparison() -> list[tuple[str, bool, object]]:
    """(platform, advised, SimReport) for 2 GiB of inputs priced 4 times,
    with and without READ_MOSTLY on the inputs."""
    rows = []
    for platform in (INTEL_PASCAL, P9_VOLTA):
        for advised in (False, True):
            sim = UMSimulator(platform)
            sim.alloc("inputs", 2 * 2**30, role="input")
            sim.host_write("inputs")
            sim.alloc("outputs", 2 * 2**29, role="output")
            if advised:
                sim.advise_read_mostly("inputs")
            for _ in range(4):
                sim.kernel("price", flops=5e9, reads=["inputs"], writes=["outputs"])
            sim.host_read("outputs")
            rows.append((platform.name, advised, sim.finish()))
    return rows


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    parser.add_argument("--hbm-bytes", type=float, default=None,
                        help="device memory to plan against (default: the card's)")
    args = parser.parse_args(argv)
    dev = resolve(args.device)

    banner("1. Memory advises on a simulated UM platform (paper §II-B)")
    advise = advise_comparison()
    for name, advised, r in advise:
        tag = "advised " if advised else "baseline"
        print(f"  {name:18s} {tag}: {r.total_s * 1e3:8.1f} ms "
              f"(stall {r.fault_stall_s * 1e3:6.1f} ms, "
              f"faults {r.n_faults})")

    print()
    banner("2. Residency planning for the assigned architectures (paper §II-D)")
    plans = {}
    for arch_name in ARCHS:
        plan = plan_cell(get_config(arch_name), get_shape("train_4k"),
                         MeshConfig(multi_pod=False), hbm_bytes=args.hbm_bytes,
                         device=dev)
        s = plans[arch_name] = plan.summary()
        print(f"  {arch_name:16s} device={s['device_gb']:6.1f} GB "
              f"fits={s['fits']} decisions={s['decisions']}")

    print()
    banner(f"3. The Black-Scholes kernel on {dev.type} "
           f"({'the CUDA kernel' if dev.type == 'cuda' else 'its plain version'})")
    g = torch.Generator(device=dev).manual_seed(0)
    s = torch.empty(8, device=dev).uniform_(10.0, 20.0, generator=g)
    x = torch.full((8,), 15.0, device=dev)
    t = torch.full((8,), 2.0, device=dev)
    call, put = black_scholes(s, x, t)
    print("  spot:", [f"{v:.2f}" for v in s.tolist()])
    print("  call:", [f"{v:.2f}" for v in call.tolist()])
    print("  put: ", [f"{v:.2f}" for v in put.tolist()])
    return {"advise": advise, "plans": plans,
            "bs": {"s": s, "x": x, "t": t, "call": call, "put": put}}


if __name__ == "__main__":
    main()
