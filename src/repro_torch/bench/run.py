"""Benchmark entry point of the port: the counterpart of ``benchmarks/run.py``.

    PYTHONPATH=src python -m repro_torch.bench.run [--fast] [--json] [--resume]
        [--out PATH] [--device DEVICE]

Emits, as CSV blocks:
  fig3/fig6     the paper's in-memory/oversubscribed tables (simulated UM)
  fig4_7        traced-app breakdowns (compute/stall/HtoD/DtoH)
  claims        headline-claim summary vs paper expectations
  ext           extended sweep (grace-hopper-c2c + 200 % regime) [not --fast]
  psched        staged vs pipelined prefetch scheduling (§11) [not --fast]
  page          full-matrix 64 KB page-granularity sweep [not --fast]
  pagegate      §16 bounds gate over the page sweep (own timed block, so
                page_matrix_wall_s keeps measuring the sweep) [not --fast]
  degradation   injected-fault scenarios x adaptive-vs-static tiers (§12)
                [not --fast]
  serving       continuous-batching serving tier: traffic x variant x KV
                regime latency/goodput (§13) [not --fast]
  boundstight   static-bounds tightness: measured-vs-provable-bound ratios
                per platform x regime x strategy kind (§16) [not --fast]
  table1        working-set sizing
  kernel        CUDA kernel call timings vs their plain PyTorch versions
                (``bench.lm_bench.kernel_rows``) [not --fast]
  lm            per-arch reduced train/decode step timings
                (``bench.lm_bench.arch_step_rows``) [not --fast]
  roofline      roofline terms per (arch x shape) from the port's dry-run
                records (``bench.roofline``)
  dryrun        dry-run trace/memory summary, both meshes

The simulated blocks run on the host; ``kernel`` and ``lm`` run on the CUDA
card unless ``--device cpu`` is given.

``--json`` additionally writes ``BENCH_umbench_torch.json`` (or ``--out
PATH``; a directory gets that file name inside it), through a temporary
file and an atomic rename: wall-clock seconds per block, the host they ran
on, the simulated totals of every matrix cell and, when a previous artifact
exists at the same path, per-cell deltas against it.  It never writes the
JAX package's ``BENCH_umbench.json``, and it records its own wall seconds
without dividing them by the reference's seed-engine baselines, which were
taken on another host.

The pooled sweeps journal every completed cell to
``.umbench_torch_journal/`` beside the artifact (fsync'd JSONL, DESIGN.md
§12).  ``--resume`` replays completed cells from the journals of a previous
interrupted run and re-runs only the rest; without it, stale journals are
truncated.  The journal directory is removed after a fully successful run.
Outside ``--fast`` the pooled sweeps also consult the content-addressed
cell cache in ``.umbench_torch_cellcache/`` beside the artifact (DESIGN.md
§15).  Both directories are the port's own, so a resume or a cache hit can
never replay a cell of the reference's sweep.
"""
from __future__ import annotations

import argparse
import json
import os
import platform
import shutil
import time

BENCH_PATH = "BENCH_umbench_torch.json"
JOURNAL_DIR = ".umbench_torch_journal"
CACHE_DIR = ".umbench_torch_cellcache"


# the cell-identity axes, in key order; new_axis_values labels fresh axis
# values by these names, so _cell_key derives its tuple from the same list
_KEY_FIELDS = ("app", "platform", "variant", "regime", "granularity")
_KEY_DEFAULTS = {"granularity": "group"}   # absent pre-page-mode artifacts


def _cell_key(row) -> tuple | None:
    """Matching key for a benchmark cell row, or None when the row cannot
    carry one (a malformed/older-schema artifact row — e.g. a plain
    string, or a dict missing app/platform/variant/regime).  ``granularity``
    alone may be absent (pre-page-mode artifacts default to "group")."""
    if not isinstance(row, dict):
        return None
    try:
        key = tuple(row.get(f, _KEY_DEFAULTS[f]) if f in _KEY_DEFAULTS
                    else row[f] for f in _KEY_FIELDS)
        hash(key)       # unhashable field values (e.g. lists) -> unmatchable
    except (KeyError, TypeError):
        return None
    return key


def cell_deltas(prev_cells: list[dict], cells: list[dict],
                cached_keys=()) -> dict:
    """Per-cell simulated-total deltas vs the previous artifact.  Cells are
    matched on (app, platform, variant, regime, granularity); only changed
    cells are listed (sorted by |delta|, worst first) so an unchanged sweep
    produces an empty list, not 240 zeros.  Cells this run *added* to the
    matrix are labelled, not diffed: ``new_axis_values`` names the axis
    values (new variants, platforms, granularities, ...) the predecessor
    never swept, so a grown matrix reads as "N new cells from these axes"
    instead of folding into the changed-cell percentages — only cells
    present in both artifacts can appear under ``changed``.  Prior-artifact
    rows without a usable key (older schema) are unmatchable: they count as
    removed, and current cells they would have matched count as new — the
    diff degrades instead of raising.

    Failure records are labelled, never diffed: a row carrying ``error``
    (a timed-out/crashed cell, possibly transient) lands under ``errored``
    with ``cells_error`` counting them, on either side of the diff — a
    current error cell is not "changed" (its None total vs a number is a
    failure, not a perf delta) and a prior error cell that vanished is not
    "removed" (coverage did not shrink; a failure stopped recurring).

    ``cached_keys`` names cells answered by the content-addressed cell
    cache (5-field key tuples).  A cache hit is by construction the same
    bits a re-run would produce — it can never be a perf delta, so those
    cells are compared but never listed as changed (a divergence there
    would mean the *predecessor artifact*, not this sweep, was produced by
    different code)."""
    prev = {}
    prev_err: set = set()
    for r in prev_cells:
        key = _cell_key(r)
        if key is None:
            continue
        if isinstance(r, dict) and r.get("error") is not None:
            prev_err.add(key)
        else:
            prev[key] = r.get("total_s")
    unmatchable_prev = len(prev_cells) - len(prev) - len(prev_err)
    cur_keys = {k for k in (_cell_key(r) for r in cells) if k is not None}
    # axis values swept now but never by the predecessor — the newly added
    # variants/columns whose cells are "new", never "changed"
    new_axis_values = {}
    prev_axis_keys = set(prev) | prev_err
    for i, field in enumerate(_KEY_FIELDS):
        fresh = sorted({k[i] for k in cur_keys} - {k[i] for k in prev_axis_keys})
        if fresh:
            new_axis_values[field] = fresh
    changed = []
    errored = []
    compared = 0
    for row in cells:
        key = _cell_key(row)
        if isinstance(row, dict) and row.get("error") is not None:
            errored.append({"cell": None if key is None else list(key),
                            "error": row["error"],
                            **({} if row.get("error_kind") is None
                               else {"error_kind": row["error_kind"]})})
            continue
        if key is None or key not in prev:
            continue
        compared += 1
        old, new = prev[key], row.get("total_s")
        if old == new or key in cached_keys:
            continue
        delta = {"cell": list(key), "prev_total_s": old, "total_s": new}
        if old and new is not None:
            delta["delta_pct"] = round(100.0 * (new - old) / old, 3)
        changed.append(delta)
    changed.sort(key=lambda d: abs(d.get("delta_pct", float("inf"))),
                 reverse=True)
    return {
        "cells_compared": compared,
        "cells_changed": len(changed),
        "cells_new": len(cells) - compared - len(errored),
        "cells_error": len(errored),
        "new_axis_values": new_axis_values,
        # cells the predecessor had but this sweep lost — a non-zero count
        # means matrix coverage shrank, not that performance held (error
        # records on either side never count here: a failure is not
        # coverage, and a failure that stopped recurring is not a loss)
        "cells_removed": len(set(prev) - cur_keys) + unmatchable_prev,
        "errored": errored,
        "changed": changed,
    }


def _out_path(out: str | None) -> str:
    if out is None:
        return BENCH_PATH
    return os.path.join(out, BENCH_PATH) if os.path.isdir(out) else out


def host_info() -> dict:
    """The host the wall seconds were taken on, and the card if there is one."""
    import torch
    return {
        "node": platform.node(),
        "machine": platform.machine(),
        "platform": platform.platform(),
        "cpu_count": os.cpu_count(),
        "python": platform.python_version(),
        "torch": torch.__version__,
        "device": (torch.cuda.get_device_name(0) if torch.cuda.is_available()
                   else None),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.bench.run",
                                 description="the port's benchmark tables")
    ap.add_argument("--fast", action="store_true",
                    help="the seed matrix's tables only (no ext/page/"
                         "degradation/serving/kernel/lm blocks)")
    ap.add_argument("--json", action="store_true",
                    help=f"write the artifact ({BENCH_PATH} by default)")
    ap.add_argument("--resume", action="store_true",
                    help="replay the journals of an interrupted run")
    ap.add_argument("--out", default=None,
                    help="artifact path, or a directory to write it in")
    ap.add_argument("--device", default=None,
                    help="torch device of the kernel and lm blocks "
                         "(default: the CUDA card)")
    args = ap.parse_args(argv)
    from repro_torch.bench import lm_bench, paper_tables, roofline

    out = _out_path(args.out)
    where = os.path.dirname(out)
    journal_dir = os.path.join(where, JOURNAL_DIR)
    # crash-safe sweeps (§12): every pooled sweep checkpoints per-cell;
    # --resume replays completed cells of an interrupted previous run
    paper_tables.configure_journals(journal_dir, resume=args.resume)
    # content-addressed cell cache (§15): unlike the journals it survives
    # successful runs, so a re-run only recomputes cells whose workload,
    # strategy, axes, or engine code actually changed
    if not args.fast:
        paper_tables.configure_cache(os.path.join(where, CACHE_DIR))

    timings: dict[str, float] = {}
    blocks: list[list[str]] = []

    def timed(name: str, fn) -> None:
        t0 = time.perf_counter()
        blocks.append(fn())
        timings[name] = round(time.perf_counter() - t0, 3)

    t0 = time.perf_counter()
    paper_tables.matrix_cells()
    matrix_wall = time.perf_counter() - t0
    timings["matrix_240"] = round(matrix_wall, 3)

    timed("claims", paper_tables.table_claims_summary)
    timed("table1", paper_tables.table_working_sets)
    timed("fig3", paper_tables.table_fig3_in_memory)
    timed("fig6", paper_tables.table_fig6_oversubscribed)
    timed("fig4_7", paper_tables.table_fig4_7_breakdowns)
    if not args.fast:
        timed("ext", paper_tables.table_extended_sweep)
        timed("psched", paper_tables.table_prefetch_pipeline)
        timed("page", paper_tables.table_page_granularity)
        timed("pagegate", paper_tables.table_page_bounds_gate)
        timed("degradation", paper_tables.table_degradation)
        timed("serving", paper_tables.table_serving)
        timed("boundstight", paper_tables.table_bounds_tightness)
        timed("kernel", lambda: lm_bench.kernel_rows(args.device))
        timed("lm", lambda: lm_bench.arch_step_rows(device=args.device))
    timed("roofline", roofline.roofline_rows)
    timed("dryrun", roofline.dryrun_rows)

    for block in blocks:
        for line in block:
            print(line)
        print()

    if args.json:
        prev = None
        if os.path.exists(out):
            try:
                with open(out) as f:
                    prev = json.load(f)
            except (OSError, ValueError):
                prev = None
        cells = paper_tables.matrix_cells(extended=not args.fast)
        if not args.fast:
            # clean serving cells only: the fault-composed block shares the
            # 5-field cell key with its clean counterparts, and the cell
            # list carries one row per key
            cells = (cells + paper_tables.page_cells()
                     + paper_tables.serving_cells())
        # the pool each pooled sweep REALLY used; the seed 240-cell matrix
        # stays serial and is excluded
        sweep_workers = (max(paper_tables.SWEEP_WORKERS_USED.values())
                         if paper_tables.SWEEP_WORKERS_USED else 1)
        rows = [c.row() for c in cells]
        payload = {
            "matrix_240_wall_s": round(matrix_wall, 3),
            # the wall seconds above are this host's: no ratio to the
            # reference's seed-engine baselines, which another host took
            "host": host_info(),
            "sweep_workers": sweep_workers,
            "sweep_workers_used": dict(paper_tables.SWEEP_WORKERS_USED),
            "block_wall_s": timings,
            **({"page_matrix_wall_s": timings.get("page")} if not args.fast
               else {}),
            "n_cells": len(cells),
            "journal_stats": {k: {"reused": r, "ran": n}
                              for k, (r, n)
                              in paper_tables.JOURNAL_STATS.items()},
            "cache_report": paper_tables.CACHE_STATS,
            "bounds_report": dict(paper_tables.BOUNDS_STATS),
            "bounds_checked": sum(v["checked"]
                                  for v in paper_tables.BOUNDS_STATS.values()),
            "bounds_violations": sum(
                v["violations"]
                for v in paper_tables.BOUNDS_STATS.values()),
            "cells": rows,
        }
        # clean (faults=None) cache-hit cells, projected onto the 5-field
        # key: by construction bit-identical to a re-run, so never
        # "changed" in the diff below
        cached = {k[:5] for k in paper_tables.CACHE_HIT_KEYS if k[5] is None}
        if prev is not None:
            payload["vs_prev"] = {
                "prev_matrix_240_wall_s": prev.get("matrix_240_wall_s"),
                **cell_deltas(prev.get("cells", []), rows,
                              cached_keys=cached),
            }
        # temp file + atomic rename: a crash mid-dump leaves the previous
        # artifact intact instead of a torn one
        tmp = out + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, out)
        vs = payload.get("vs_prev")
        trail = (f", {vs['cells_changed']}/{vs['cells_compared']} cells "
                 f"changed vs prev" if vs else "")
        print(f"wrote {out} ({len(cells)} cells, "
              f"matrix {matrix_wall:.2f}s{trail})")

    if paper_tables.JOURNAL_STATS:
        stats = ", ".join(f"{k}: {r} reused/{n} ran"
                          for k, (r, n) in paper_tables.JOURNAL_STATS.items())
        print(f"sweep journals ({journal_dir}): {stats}")
    if paper_tables.CACHE_STATS:
        rep = ", ".join(
            f"{k}: {v['hits']} hits/"
            + "+".join(f"{n} {reason}" for reason, n in v["misses"].items())
            for k, v in paper_tables.CACHE_STATS.items())
        print(f"cell cache ({os.path.join(where, CACHE_DIR)}): {rep}")
    # everything completed: the checkpoints have served their purpose (the
    # cell cache, unlike the journals, persists)
    shutil.rmtree(journal_dir, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
