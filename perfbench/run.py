"""Runs one cell of the port's benchmark once and prints its result.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout on a machine with the cell's CUDA cards.  The
last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``); the last lines of standard error give
each number compared beside its limit.  Exits 2, printing no result,
without enough CUDA cards, and 3 if JAX or the JAX package was loaded.
"""
from __future__ import annotations

import sys
import time

T_START = time.perf_counter()
# this file's directory would shadow modules of other names (``trace``)
if sys.path and sys.path[0] and __file__.startswith(sys.path[0]):
    sys.path.pop(0)

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / "build" / "perfbench-cache"


def _paths() -> None:
    """The checkout's ``perfbench`` and the port (``src``) importable, and
    every build or kernel cache at a fixed directory inside the checkout."""
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(CACHE / sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _paths()
    from perfbench import cells, guard, spec

    bench = spec.load_benchmark()
    cell = spec.workload(bench, args.workload)
    file, traffic = spec.load_config(cell["config"]), spec.load_traffic(cell["traffic"])
    limits = spec.load_check(cell["name"])

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); this machine has {n}",
              file=sys.stderr)
        return 2
    result = cells.run_cell(bench, cell, file, traffic, limits, args.seed, args.seconds,
                            bool(args.trace), torch.device("cuda"), T_START)
    loaded = guard.forbidden()
    if loaded:
        print(f"the run loaded {loaded}: the benchmark may not import JAX or the JAX "
              "package", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        limit = "not compared" if c["limit"] is None else f"limit {c['limit']!r}"
        print(f"check {name} {c['value']!r} {limit}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
