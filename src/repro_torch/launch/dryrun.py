"""Multi-device dry-run: the counterpart of ``repro.launch.dryrun``.

For every (architecture x input shape x mesh) cell:
  1. residency plan (oversubscription decisions recorded),
  2. the step traced on fake tensors (``FakeTensorMode``) placed on a
     fake-backend mesh of the cell's size: no device, no data,
  3. the traced peak of live tensor bytes on one rank -> per-device fit,
  4. FLOPs, bytes accessed and collectives counted at the rank's level
     (``launch.analysis.TraceCounter``),
  5. L=1/L=2 probes -> extrapolated roofline terms (H100 constants).

The trace runs on the host and touches no card; it is not a fallback, and
its times are a roofline estimate for a mesh of H100s, not a measurement.
The fake process group lives in this command's process only.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch starcoder2-3b \\
      --shape train_4k [--multi-pod] [--no-probes] [--out artifacts/torch_dryrun]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import time
import traceback

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor

from repro_torch.configs import ARCH_NAMES, get_config, get_shape
from repro_torch.configs.base import ArchConfig, MeshConfig, ShapeConfig
from repro_torch.core.residency import plan_cell
from repro_torch.launch import analysis
from repro_torch.launch.analysis import TraceCounter, _storage_bytes
from repro_torch.launch.mesh import fake_process_group
from repro_torch.launch.step import (
    _adamw_cfg,
    build_prefill_step,
    build_serve_step,
    build_train_step,
    input_specs,
    place_batch,
    place_caches,
    place_train_state,
)
from repro_torch.launch.sharding import distribute_module, param_specs
from repro_torch.models import transformer as tf
from repro_torch.optim import init_state

GB = 1024**3
DEFAULT_OUT = pathlib.Path("artifacts/torch_dryrun")
HBM_BYTES = 80e9  # the planner's capacity: one H100's 80 GB


def dryrun_mesh(shape, axes) -> DeviceMesh:
    """A CPU mesh over the first ranks of the fake group (started here at
    512 ranks, the largest mesh, when the process has none)."""
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized():
        fake_process_group(max(n, 512))
    if dist.get_backend() != "fake" or dist.get_world_size() < n:
        raise RuntimeError(f"the dry-run needs the fake backend with at least {n} ranks")
    return DeviceMesh("cpu", torch.arange(n).reshape(shape), mesh_dim_names=tuple(axes))


def _tensors(tree):
    """A tree with each module replaced by the list of its parameters."""
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters())
    if isinstance(tree, (tuple, list)):
        return [_tensors(t) for t in tree]
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return tree


def _storages(tree) -> dict[int, int]:
    """{storage id: bytes} of the distinct storages of ``tree``'s local
    tensors."""
    out = {}
    for t in torch.utils._pytree.tree_leaves(_tensors(tree)):
        if isinstance(t, torch.Tensor):
            key, n = _storage_bytes(t._local_tensor if isinstance(t, DTensor) else t)
            out[key] = n
    return out


def trace_step(arch: ArchConfig, shape: ShapeConfig, mesh, plan=None) -> dict:
    """Trace one step of ``shape.kind`` on fake tensors placed on ``mesh``:
    {"flops", "bytes", "collective_bytes", "collectives", "memory"} for one
    rank.  ``memory`` keeps the reference's fields: the arguments
    (parameters, state, batch, caches), the outputs, the outputs that are
    arguments updated in place (alias), the temporaries (the peak above the
    arguments and the new outputs) and peak_extra (the peak above the
    arguments), in GB (2^30 bytes)."""
    cfg = arch.model
    with analysis.dtensor_planning(host_index_math=True), FakeTensorMode():
        params = tf.Transformer(cfg, "cpu")
        if shape.kind == "train":
            state = init_state(params, _adamw_cfg(arch, plan))
            params, state = place_train_state(arch, params, state, mesh)
            batch = input_specs(arch, shape, "cpu")
            if arch.train.microbatches == 1:  # else the step places each microbatch
                batch = place_batch(arch, batch, mesh, "train")
            step = build_train_step(arch, shape, mesh, plan)
            args = (params, state, batch, 1)
        else:
            distribute_module(params, param_specs(cfg, params), mesh)
            batch = place_batch(arch, input_specs(arch, shape, "cpu"), mesh, shape.kind)
            if shape.kind == "prefill":
                step = build_prefill_step(arch, mesh)
                args = (params, batch)
            else:
                caches = place_caches(arch, tf.init_caches(cfg, shape.global_batch,
                                                           shape.seq_len, "cpu"), mesh)
                step = build_serve_step(arch, mesh)
                args = (params, batch, caches, shape.seq_len - 1)
        counter = TraceCounter()
        counter.track(_tensors(args))
        with counter:
            out = step(*args)
        arg = _storages(args)
        new = _storages(out)
    peak, arg_bytes = counter.peak, sum(arg.values())
    out_bytes = sum(new.values())
    alias = sum(n for k, n in new.items() if k in arg)
    colls = counter.collectives()
    return {
        "flops": float(counter.flops),
        "bytes": float(counter.bytes),
        "collective_bytes": float(colls.link_bytes),
        "collectives": colls.as_dict(),
        "collective_sites": counter.sites(),
        "memory": {
            "argument_gb": arg_bytes / GB,
            "output_gb": out_bytes / GB,
            "temp_gb": (peak - arg_bytes - (out_bytes - alias)) / GB,
            "alias_gb": alias / GB,
            "peak_extra_gb": (peak - arg_bytes) / GB,
        },
    }


def _probe_stats(arch: ArchConfig, shape: ShapeConfig, mesh, plan, L: int) -> dict:
    arch_l = dataclasses.replace(arch, model=dataclasses.replace(arch.model, num_layers=L))
    stats = trace_step(arch_l, shape, mesh, plan)
    stats.pop("memory")
    stats.pop("collective_sites")
    return stats


def run_cell(arch_name: str, shape_name: str, *, multi_pod: bool,
             probes: bool = True, outdir: pathlib.Path = DEFAULT_OUT,
             arch: ArchConfig | None = None, mesh_shape: tuple | None = None) -> dict:
    """Plan, trace and record one cell on the production mesh.  ``arch``
    (a cut or reduced copy of the named config) and ``mesh_shape`` (over
    the same axes) stand in for the named config and the production mesh
    in the tests."""
    arch = arch or get_config(arch_name)
    shape = get_shape(shape_name)
    mesh_cfg = MeshConfig(multi_pod)
    grid = tuple(mesh_shape or mesh_cfg.shape)
    mesh_tag = "x".join(map(str, grid))
    chips = 1
    for n in grid:
        chips *= n
    record: dict = {
        "arch": arch_name, "shape": shape_name, "mesh": mesh_tag,
        "multi_pod": multi_pod, "chips": chips,
    }
    ok, reason = arch.supports_shape(shape)
    if not ok:
        record["status"] = "skipped"
        record["reason"] = reason
        _write(record, outdir)
        return record

    plan = plan_cell(arch, shape, mesh_cfg, hbm_bytes=HBM_BYTES)
    record["residency_plan"] = plan.summary()
    mesh = dryrun_mesh(grid, mesh_cfg.axis_names)
    try:
        t0 = time.time()
        stats = trace_step(arch, shape, mesh, plan)
        record["compile_s"] = round(time.time() - t0, 1)  # the trace's seconds
        record["memory_analysis"] = stats["memory"]
        record["cost_analysis_raw"] = {"flops": stats["flops"],
                                       "bytes_accessed": stats["bytes"]}
        # the reference's keys, and the bytes by the call sites that caused them
        record["collectives_raw"] = {**stats["collectives"], "sites": stats["collective_sites"]}
        record["status"] = "ok"
    except Exception as e:  # noqa: BLE001 — a failing cell is a bug to surface
        record["status"] = "failed"
        record["error"] = f"{type(e).__name__}: {e}"
        record["traceback"] = traceback.format_exc()[-2000:]
        _write(record, outdir)
        return record

    if probes:
        try:
            p1 = _probe_stats(arch, shape, mesh, plan, 1)
            p2 = _probe_stats(arch, shape, mesh, plan, 2)
            L = arch.model.num_layers
            roof = analysis.Roofline(
                arch=arch_name, shape=shape_name, mesh=mesh_tag, chips=chips,
                hlo_flops_per_chip=analysis.extrapolate(p1["flops"], p2["flops"], L),
                hlo_bytes_per_chip=analysis.extrapolate(p1["bytes"], p2["bytes"], L),
                collective_bytes_per_chip=max(analysis.extrapolate(
                    p1["collective_bytes"], p2["collective_bytes"], L), 0.0),
                model_flops_total=analysis.model_flops(arch, shape),
            )
            record["probes"] = {"L1": p1, "L2": p2}
            record["roofline"] = roof.as_dict()
        except Exception as e:  # noqa: BLE001
            record["probe_error"] = f"{type(e).__name__}: {e}"
            record["probe_traceback"] = traceback.format_exc()[-2000:]

    _write(record, outdir)
    return record


def _write(record: dict, outdir: pathlib.Path) -> None:
    outdir = pathlib.Path(outdir)
    outdir.mkdir(parents=True, exist_ok=True)
    name = f"{record['arch']}_{record['shape']}_{record['mesh']}.json"
    (outdir / name).write_text(json.dumps(record, indent=1))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape", choices=["train_4k", "prefill_32k",
                                        "decode_32k", "long_500k"])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-probes", action="store_true")
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    args = ap.parse_args(argv)
    out = pathlib.Path(args.out)

    cells = []
    if args.all:
        for a in ARCH_NAMES:
            for s in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
                for mp in (False, True):
                    cells.append((a, s, mp))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape required unless --all")
        cells = [(args.arch, args.shape, args.multi_pod)]

    failures = 0
    for a, s, mp in cells:
        t0 = time.time()
        rec = run_cell(a, s, multi_pod=mp, probes=not args.no_probes, outdir=out)
        status = rec["status"]
        extra = ""
        if status == "ok":
            mem = rec["memory_analysis"]
            extra = f"perdev={mem['peak_extra_gb'] + mem['argument_gb']:.2f}GB"
            if "roofline" in rec:
                extra += f" bound={rec['roofline']['bound']}"
        elif status == "failed":
            failures += 1
            extra = rec["error"][:120]
        print(f"[{status:7s}] {a:18s} {s:12s} mesh={rec['mesh']:8s} "
              f"({time.time()-t0:5.1f}s) {extra}", flush=True)
    if failures:
        raise SystemExit(f"{failures} cells failed")


if __name__ == "__main__":
    main()
