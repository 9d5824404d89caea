"""One run of one cell, from its files to the result's line."""
from __future__ import annotations

import sys

import torch

from perfbench import check, serve_cell, spec, trace, train_cell
from perfbench.modelspec import spec_of

KINDS = {"serve": serve_cell.run, "train": train_cell.run}


def run_cell(bench: dict, cell: dict, file: dict, traffic: dict, limits: dict, seed: int,
             seconds: float, traced: bool, dev, t_start: float) -> dict:
    """The result of one run: ``correct``, ``attempted``, ``failed``, the
    metrics the cell reports (``spec.metrics_for``), ``device``, with
    ``traced`` the ``breakdown``, and last ``checks``, each number with its
    limit (null for a number that is read and not compared)."""
    m = spec_of(cell["config"], file)
    facts, numbers = KINDS[traffic["kind"]](m, file, traffic, seed, seconds, traced, dev,
                                            t_start)
    if facts["spans"] is not None:
        print(trace.describe(facts["spans"]), file=sys.stderr)
    metrics = {}
    for entry in spec.metrics_for(bench, cell["name"], traced):
        value = spec.load_reader(entry["name"], traffic["kind"]).read(facts)
        if value is None and not traced:
            raise RuntimeError(f"{cell['name']}: end-to-end {entry['name']} read nothing")
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    cuda = dev.type == "cuda"
    device = {"platform": "gpu" if cuda else dev.type,
              "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
              "count": cell["chips"], "memory_peak_bytes": facts["memory_peak_bytes"]}
    out = {"correct": check.judge(numbers, limits["limits"]) and facts["failed"] == 0,
           "attempted": facts["attempted"], "failed": facts["failed"], "metrics": metrics,
           "device": device}
    if traced:
        device.update(busy_s=facts["trace"]["busy_s"], window_s=facts["trace"]["window_s"])
        out["breakdown"] = {k: facts["trace"][k] for k in ("device_ops", "idle_gaps")}
    out["checks"] = {k: {"value": v, "limit": limits["limits"].get(k)}
                     for k, v in numbers.items()}
    return out
