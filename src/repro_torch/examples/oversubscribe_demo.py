"""Oversubscription end to end: the counterpart of
``examples/oversubscribe_demo.py``.

    PYTHONPATH=src python -m repro_torch.examples.oversubscribe_demo \
        [--device cpu --hbm-bytes N]

1. The ResidencyPlanner's escalation for grok-1-314b / train_4k on the
   reference's 256-device mesh, at the card's memory a device.
2. The KV host tier it plans for an extreme decode working set.
3. Paged decode over a block-table KV pool.
4. The same oversubscription on the paper's Intel-Volta, in the UM
   simulator: basic UM against UM+Advise.

On the CPU there is no card's memory to plan against: ``--hbm-bytes``
gives it.
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.configs import MeshConfig, ModelConfig, ShapeConfig, get_config, get_shape
from repro_torch.core import UMSimulator
from repro_torch.core.residency import GB, ResidencyPlanner
from repro_torch.device import resolve
from repro_torch.kernels import paged_attention
from repro_torch.umbench.platforms import INTEL_VOLTA


def paged_decode(model: str | ModelConfig = "qwen2-72b", *, batch: int = 2,
                 pages: int = 8, page_size: int = 64,
                 dtype: torch.dtype = torch.float32, seed: int = 0,
                 seq_lens=None, device=None) -> dict:
    """One decode step of ``batch`` sequences over a pool of
    ``batch * pages`` pages of ``page_size`` positions, at the attention
    geometry (Hq, Hkv, Dh) of ``model`` (a name or a ``ModelConfig``).

    The pools and the query are N(0, 1) draws of a ``torch.Generator`` on
    the target device, made in ``dtype``.  The block table gives sequence
    b pages b*pages .. (b+1)*pages - 1 in order.  The default lengths are
    the demo's: full for even rows, half for odd rows.  Returns the inputs
    and ``out`` (B, Hq, Dh), computed by the paged attention kernel on a
    CUDA device and by its plain version on the CPU.
    """
    cfg = get_config(model).model if isinstance(model, str) else model
    dev = resolve(device)
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    npages = batch * pages
    g = torch.Generator(device=dev).manual_seed(seed)
    pool_shape = (npages, page_size, hkv, dh)
    k_pool = torch.randn(pool_shape, generator=g, device=dev, dtype=dtype)
    v_pool = torch.randn(pool_shape, generator=g, device=dev, dtype=dtype)
    q = torch.randn((batch, hq, dh), generator=g, device=dev, dtype=dtype)
    block_table = torch.arange(npages, dtype=torch.int32, device=dev).reshape(batch, pages)
    if seq_lens is None:
        full = page_size * pages
        seq_lens = [full if b % 2 == 0 else full // 2 for b in range(batch)]
    seq_lens = torch.as_tensor(seq_lens, dtype=torch.int32).to(dev)
    out = paged_attention(q, k_pool, v_pool, block_table, seq_lens)
    return {"q": q, "k_pool": k_pool, "v_pool": v_pool,
            "block_table": block_table, "seq_lens": seq_lens, "out": out}


# The demo's own toy geometry: B=2, Hq=8, Hkv=2, Dh=64, 8 pages of 64.
TOY = dataclasses.replace(get_config("qwen2-72b").model, name="toy", num_heads=8,
                          num_kv_heads=2, head_dim=64)


def volta_oversubscription() -> dict:
    """Section 4: 10 GiB of weights and a 14 GiB KV cache decoded 4 times
    on the 16 GiB Intel-Volta, with and without READ_MOSTLY on the weights.
    Prints a line for each and returns {variant: SimReport}."""
    reports = {}
    for variant, advise in (("basic UM", False), ("UM+Advise", True)):
        sim = UMSimulator(INTEL_VOLTA)
        sim.alloc("weights", int(10 * GB), role="weights")
        sim.alloc("kv", int(14 * GB), role="kv_cache")
        sim.host_write("weights")
        if advise:
            sim.advise_read_mostly("weights")   # weights: clean drops on evict
        for _ in range(4):
            sim.kernel("decode", flops=2e12, reads=["weights", "kv"], writes=["kv"])
        r = reports[variant] = sim.finish()
        print(f"  {variant:10s}: {r.total_s:6.2f} s "
              f"(DtoH {r.dtoh_bytes / GB:5.1f} GB, evictions {r.n_evictions})")
    return reports


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    parser.add_argument("--hbm-bytes", type=float, default=None,
                        help="device memory to plan against (default: the card's)")
    args = parser.parse_args(argv)
    planner = ResidencyPlanner(args.hbm_bytes, device=args.device)
    print("=" * 72)
    print(f"1. Planner escalation for grok-1-314b / train_4k @ 256 devices "
          f"({planner.capacity / GB:.1f} GB usable each)")
    print("=" * 72)
    plan = planner.plan(get_config("grok-1-314b"), get_shape("train_4k"), MeshConfig(False))
    for d in plan.decisions:
        print("  -", d)
    print(f"  device: {plan.device_bytes / GB:.1f} GB  host: "
          f"{plan.host_bytes / GB:.1f} GB  fits={plan.fits}")

    print()
    print("=" * 72)
    print("2. KV host tier for an extreme decode working set")
    print("=" * 72)
    huge = ShapeConfig("huge", seq_len=524_288, global_batch=512, kind="decode")
    plan = planner.plan(get_config("qwen2-72b"), huge, MeshConfig(False))
    for d in plan.decisions:
        print("  -", d)
    print(f"  KV device fraction: {plan.kv_device_fraction:.2f}")

    print()
    print("=" * 72)
    print("3. Paged decode over a block-table pool (hot pages on device)")
    print("=" * 72)
    res = paged_decode(TOY, batch=2, pages=8, page_size=64, device=args.device)
    out = res["out"]
    npages = res["k_pool"].shape[0]
    print(f"  paged attention over {npages} pages -> out {tuple(out.shape)}, "
          f"finite={bool(torch.isfinite(out).all())}")

    print()
    print("=" * 72)
    print("4. The same oversubscription on the paper's Intel-Volta (simulated)")
    print("=" * 72)
    volta_oversubscription()


if __name__ == "__main__":
    main()
