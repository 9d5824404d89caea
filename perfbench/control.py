"""The readings that the limits of ``checks/<workload>.json`` are set from:
the program's numbers on many seeds, and the control's on a few, in one
process (the benchmark's own runs never run the control).

    python3 perfbench/control.py --workload <name> --seeds 1,2,3 \\
        [--control-seeds 4,5,6] [--seconds S]

Each program seed is one run of the cell with a window of ``--seconds``
(its numbers as a timed run computes them); with ``--fault`` the program
runs with that fault of ``faults.py`` planted.  The control is the reference
put in the program's place in fp8 (``reference.precision.FP8``), the step
below the served bf16: for a training cell the fp8 reference's steps held
against the fp32 reference's; for a serving cell, on the prompts and
served tokens of a program run on that seed, the fp32 reference's gap of
the token that the fp8 reference ranks first at each position.  One JSON
line a seed; needs a CUDA card.
"""
from __future__ import annotations

import sys
import time

T_START = time.perf_counter()
if sys.path and sys.path[0] and __file__.startswith(sys.path[0]):
    sys.path.pop(0)

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def control_numbers(bench, cell, file, traffic, seed: int, seconds: float, dev) -> dict:
    """The control's numbers on ``seed`` at the cell's own size."""
    from perfbench import check, serve_cell, train_cell
    from perfbench import weights as W
    from perfbench.modelspec import spec_of
    from perfbench.reference import train as ref_train
    from perfbench.reference.precision import FP8, FP32, exact_fp32

    m = spec_of(cell["config"], file)
    exact_fp32()
    if traffic["kind"] == "train":
        def batch(i):
            return W.train_batch(seed, i, traffic["batch"], traffic["seq_len"], m.vocab, dev)
        args = (m, file["train"], seed, batch, traffic["checked_steps"], traffic["first_step"],
                traffic["plan"] == "host", dev)
        ref = ref_train.run(*args, FP32, traffic["ref_block_rows"])
        train_cell._free(dev)
        low = ref_train.run(*args, FP8, traffic["ref_block_rows"])
        gaps = check.train_gaps(low, ref)
        print(f"control's worst gaps: {check.worst(gaps)}", file=sys.stderr)
        return check.train_numbers(gaps)
    facts, _ = serve_cell.run(m, file, traffic, seed, seconds, False, dev, time.perf_counter())
    calls = facts["served_calls"]
    rows = serve_cell.sample(seed, calls, traffic["sample_rows"])
    ids, served = serve_cell.rows_of(m, seed, calls, rows, dev)
    ref, low = (serve_cell.reference_logits(m, seed, ids, served, mm, traffic["ref_block_rows"])
                for mm in (FP32, FP8))
    return {"logit_gap": max(float(check.logit_gaps(r, x.argmax(-1)).max())
                             for r, x in zip(ref, low))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--fault", default=None, help="run the program seeds with this fault "
                    "of perfbench/faults.py planted")
    args = ap.parse_args(argv)
    from perfbench.run import _paths

    _paths()
    import torch

    from perfbench import cells, faults, spec

    bench = spec.load_benchmark()
    cell = spec.workload(bench, args.workload)
    file, traffic = spec.load_config(cell["config"]), spec.load_traffic(cell["traffic"])
    limits = spec.load_check(cell["name"])
    dev = torch.device("cuda")
    for seed in [int(s) for s in args.seeds.split(",") if s]:
        t0 = time.perf_counter()
        with faults.planted(args.fault) if args.fault else contextlib.nullcontext():
            res = cells.run_cell(bench, cell, file, traffic, limits, seed, args.seconds, False,
                                 dev, t0)
        side = f"fault {args.fault}" if args.fault else "program"
        print(json.dumps({"workload": cell["name"], "side": side, "seed": seed,
                          "numbers": {k: c["value"] for k, c in res["checks"].items()},
                          "correct": res["correct"], "metrics": res["metrics"],
                          "peak": res["device"]["memory_peak_bytes"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    for seed in [int(s) for s in args.control_seeds.split(",") if s]:
        t0 = time.perf_counter()
        numbers = control_numbers(bench, cell, file, traffic, seed, args.seconds, dev)
        print(json.dumps({"workload": cell["name"], "side": "control", "seed": seed,
                          "numbers": numbers, "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
