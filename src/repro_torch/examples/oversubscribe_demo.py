"""Paged decode over a block-table KV pool: the counterpart of section 3 of
``examples/oversubscribe_demo.py``.

    PYTHONPATH=src python -m repro_torch.examples.oversubscribe_demo [--device cpu]

Sections 1, 2 and 4 of that demo (the residency planner's escalation, the
KV host tier's plan and the UM simulator) wait for the port of the
residency planner and the UM simulator.
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch.configs import ModelConfig, get_config
from repro_torch.device import resolve
from repro_torch.kernels import paged_attention


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


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    args = parser.parse_args(argv)
    print("=" * 72)
    print("3. Paged decode over a block-table pool (hot pages on device)")
    print("=" * 72)
    res = paged_decode(TOY, batch=2, pages=8, page_size=64, device=args.device)
    out = res["out"]
    npages = res["k_pool"].shape[0]
    print(f"  paged attention over {npages} pages -> out {tuple(out.shape)}, "
          f"finite={bool(torch.isfinite(out).all())}")
    print("  (sections 1, 2 and 4 wait for the port of the residency planner "
          "and the UM simulator)")


if __name__ == "__main__":
    main()
