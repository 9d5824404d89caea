"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads`` entry) names a configuration, ``configs/<config>.json``,
and a traffic mix, ``traffic/<traffic>.json``; its limits are
``checks/<workload>.json``; each metric, end-to-end or per-layer, is read by
``metrics/<name>.py`` (``load_reader``).  Adding a cell, a mix or a metric adds files and
entries and edits none of this code.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")
E2E_SOURCES = ("host_clock", "device_trace")
TOP_KEYS = ("command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
            "per_layer")


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _json(kind: str, name: str) -> dict:
    if not NAME.fullmatch(name):
        raise ValueError(f"{kind} name {name!r} is not a benchmark name")
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file {path.relative_to(ROOT)}")
    return json.loads(path.read_text())


def load_config(name: str) -> dict:
    return _json("configs", name)


def load_traffic(name: str) -> dict:
    return _json("traffic", name)


def load_check(workload: str) -> dict:
    return _json("checks", workload)


def load_reader(metric: str, kind: str | None = None):
    """The module ``metrics/<metric>.py``, loaded by its path (a metric's
    name may hold a dot): it declares ``LAYER`` (None for an end-to-end
    metric), ``UNIT``, ``SOURCE`` and ``read(facts) -> float | None``;
    what the metric moves is ``BENCHMARK.json``'s alone.  A quantity split
    by the end-to-end metric it moves (``<quantity>.<split>``) with no file
    of its own reads ``metrics/<quantity>.<kind>.py``, the quantity's
    reader for its cell's kind of traffic (``serve`` or ``train``)."""
    if not NAME.fullmatch(metric):
        raise ValueError(f"metric name {metric!r} is not a benchmark name")
    path = HERE / "metrics" / f"{metric}.py"
    if not path.is_file() and kind is not None and "." in metric:
        path = HERE / "metrics" / f"{metric.rsplit('.', 1)[0]}.{kind}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader {path.relative_to(ROOT)}")
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def metrics_for(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics with
    ``--trace 0``, its per-layer metrics with ``--trace 1``.  A metric with
    no ``workloads`` key belongs to every cell."""
    entries = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in entries if cell in m.get("workloads", [cell])]


def problems(bench: dict) -> list[str]:
    """What in ``bench`` breaks the benchmark's rules on names, units, keys
    and the cells each metric is reported in; empty when it is sound."""
    out = []
    if tuple(bench) != TOP_KEYS:
        out.append(f"top-level keys {tuple(bench)} are not {TOP_KEYS}")
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    metrics = bench["end_to_end"] + bench["per_layer"]
    names += [m["name"] for m in metrics]
    for w in bench["workloads"]:
        names += [w["config"], w["traffic"]]
    for c in bench["configs"]:
        names += c["reduced"]
    out += [f"bad name {n!r}" for n in names if not NAME.fullmatch(n)]
    for kind in (bench["configs"], bench["workloads"], metrics):
        seen = [x["name"] for x in kind]
        out += [f"duplicate name {n!r}" for n in set(seen) if seen.count(n) > 1]
    for m in metrics:
        if not UNIT.fullmatch(m["unit"]):
            out.append(f"bad unit {m['unit']!r} of {m['name']}")
        if m["better"] not in ("lower", "higher"):
            out.append(f"{m['name']}: better is {m['better']!r}")
        if m["source"] not in SOURCES:
            out.append(f"{m['name']}: source {m['source']!r}")
    for m in bench["end_to_end"]:
        if m["source"] not in E2E_SOURCES:
            out.append(f"end-to-end {m['name']} takes its number from {m['source']}")
        if not 0.01 <= m["bound"] <= 0.25:
            out.append(f"{m['name']}: bound {m['bound']} outside [0.01, 0.25]")
    e2e = {m["name"] for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    for w in bench["workloads"]:
        reported = {m["name"] for m in metrics_for(bench, w["name"], False)}
        if "setup_s" not in reported or len(reported) < 2:
            out.append(f"{w['name']} reports {sorted(reported)}: setup_s and another")
        if not metrics_for(bench, w["name"], True):
            out.append(f"{w['name']} reports no per-layer metric")
    for m in bench["per_layer"]:
        if m["moves"] not in e2e:
            out.append(f"{m['name']} moves {m['moves']!r}, no end-to-end metric")
        for cell in m.get("workloads", sorted(cells)):
            if cell not in cells:
                out.append(f"{m['name']} names no cell {cell!r}")
            elif m["moves"] not in {x["name"] for x in metrics_for(bench, cell, False)}:
                out.append(f"{m['name']} in {cell}, which does not report {m['moves']}")
        if m["layer"] != m["layer"].strip() or "\n" in m["layer"] or "\t" in m["layer"]:
            out.append(f"{m['name']}: layer {m['layer']!r}")
    for text in ([w["why"] for w in bench["workloads"]] + [c["source"] for c in bench["configs"]]
                 + [m["layer"] for m in bench["per_layer"]] + bench["command"]):
        if not 1 <= len(text) <= 200 or "\n" in text or "\t" in text:
            out.append(f"text of {len(text)} characters: {text[:40]!r}")
    used = {w["config"] for w in bench["workloads"]}
    out += [f"config {c['name']} is used by no cell" for c in bench["configs"]
            if c["name"] not in used]
    return out
