"""Perf hillclimb runner: the counterpart of ``repro.launch.perf``.  It
traces one (arch x shape) cell on the 16 x 16 fake mesh under variant
settings (sharding mode, microbatches, remat, MoE group size) and logs the
record to artifacts/torch_perf/.  The numbers are a roofline estimate for
256 H100s from the dry-run's trace, not a measurement.

  PYTHONPATH=src python -m repro_torch.launch.perf --arch qwen2-72b \\
      --shape train_4k --tag fsdp --sharding-mode fsdp --microbatches 1
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import time

from repro_torch.configs import ARCH_NAMES, get_config, get_shape
from repro_torch.configs.base import MeshConfig
from repro_torch.core.residency import plan_cell
from repro_torch.launch import analysis
from repro_torch.launch.dryrun import HBM_BYTES, _probe_stats, dryrun_mesh, trace_step
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import set_sharding_mode

OUT = pathlib.Path("artifacts/torch_perf")


def measure(arch_name: str, shape_name: str, *, tag: str = "baseline",
            sharding_mode: str = "2d", microbatches: int | None = None,
            remat: str | None = None, moe_group: int | None = None,
            probes: bool = True, outdir: pathlib.Path = OUT) -> dict:
    arch = get_config(arch_name)
    shape = get_shape(shape_name)
    tr = arch.train
    if microbatches is not None:
        tr = dataclasses.replace(tr, microbatches=microbatches)
    if remat is not None:
        tr = dataclasses.replace(tr, remat=remat)
    arch = dataclasses.replace(arch, train=tr)
    group = moe_mod.MOE_GROUP_SIZE
    if moe_group is not None:
        moe_mod.MOE_GROUP_SIZE = moe_group

    mesh_cfg = MeshConfig(False)
    plan = plan_cell(arch, shape, mesh_cfg, hbm_bytes=HBM_BYTES)
    if remat is not None:
        plan.remat = remat
    mesh = dryrun_mesh(mesh_cfg.shape, mesh_cfg.axis_names)
    set_sharding_mode(sharding_mode)
    try:
        t0 = time.time()
        stats = trace_step(arch, shape, mesh, plan)
        rec = {
            "arch": arch_name, "shape": shape_name, "tag": tag,
            "sharding_mode": sharding_mode,
            "microbatches": arch.train.microbatches,
            "remat": plan.remat, "moe_group": moe_group,
            "compile_s": round(time.time() - t0, 1),  # the trace's seconds
            "memory_analysis": stats["memory"],
        }
        if probes:
            p1 = _probe_stats(arch, shape, mesh, plan, 1)
            p2 = _probe_stats(arch, shape, mesh, plan, 2)
            L = arch.model.num_layers
            roof = analysis.Roofline(
                arch=arch_name, shape=shape_name, mesh="16x16", chips=mesh_cfg.num_devices,
                hlo_flops_per_chip=analysis.extrapolate(p1["flops"], p2["flops"], L),
                hlo_bytes_per_chip=analysis.extrapolate(p1["bytes"], p2["bytes"], L),
                collective_bytes_per_chip=max(analysis.extrapolate(
                    p1["collective_bytes"], p2["collective_bytes"], L), 0.0),
                model_flops_total=analysis.model_flops(arch, shape),
            )
            rec["roofline"] = roof.as_dict()
    finally:
        set_sharding_mode("2d")
        moe_mod.MOE_GROUP_SIZE = group

    outdir = pathlib.Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    (outdir / f"{arch_name}_{shape_name}_{tag}.json").write_text(json.dumps(rec, indent=1))
    ro = rec.get("roofline", {})
    mem = rec["memory_analysis"]
    print(f"[{tag}] {arch_name}/{shape_name} mode={sharding_mode} "
          f"micro={rec['microbatches']} "
          f"perdev={mem['peak_extra_gb'] + mem['argument_gb']:.2f}GB "
          f"compute={ro.get('compute_s', 0):.2f}s mem={ro.get('memory_s', 0):.2f}s "
          f"coll={ro.get('collective_s', 0):.2f}s bound={ro.get('bound')} "
          f"mfu={ro.get('mfu_at_roofline', 0):.4f} (roofline estimate, 256 x H100)",
          flush=True)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES, required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--sharding-mode", default="2d", choices=("2d", "fsdp", "zero1"))
    ap.add_argument("--microbatches", type=int)
    ap.add_argument("--remat", choices=("none", "full", "offload", "dots"))
    ap.add_argument("--moe-group", type=int)
    ap.add_argument("--no-probes", action="store_true")
    args = ap.parse_args(argv)
    measure(args.arch, args.shape, tag=args.tag,
            sharding_mode=args.sharding_mode, microbatches=args.microbatches,
            remat=args.remat, moe_group=args.moe_group, probes=not args.no_probes)


if __name__ == "__main__":
    main()
