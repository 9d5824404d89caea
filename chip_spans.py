"""The port's spans on the card: the checks the CPU tests cannot make, and
what the spans read at the benchmark's sizes.

    python chip_spans.py [--phases events,serve,train,offload] [--seed N] [--out PATH]

From the root of a checkout on a machine with a CUDA card.  Prints a
line a check and one JSON line a phase (``{"<phase>": {...}}``), with
``--out`` writes the phases to that JSON file too, and exits 1 if a check
failed, 2 without a card.

- ``events``: a two-phase CUDA graph captured with recording off and on;
  the timing events its event-record nodes (``external=True``) record at
  each replay, read by ``elapsed_time``, against events around the replay,
  and its node counts (``CUDAGraph.debug_dump``); then reduced
  starcoder2-3b train steps (state on the card and on the host) captured
  with recording on against ones captured with it off, bit for bit, and a
  reduced qwen2-7b serve call's spans.
- ``serve``: qwen2-7b at full size with the benchmark's seeded weights
  (``perfbench/``), at the ``decode`` and ``prefill`` traffic: calls with
  recording off and on in turn (the recorder's cost), the spans of the on
  calls, and one call profiled with recording on, its device-idle time by
  span (``spans.idle_by_span``) beside the call's.
- ``train`` / ``offload``: starcoder2-3b at the ``train`` /
  ``train-offload`` traffic: steps of a graph captured with recording off,
  then of one captured with it on, its steps with recording off and on in
  turn; the phases' device times, and one step profiled.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import torch  # noqa: E402

from repro_torch import spans  # noqa: E402

ORDER = (False, True, True, False, False, True)  # recording off / on: three pairs in turn
GRAPH_SPANS = ("graph.capture", "serve.release")
FAILED: list[str] = []


def expect(label: str, ok: bool) -> None:
    print(f"{'ok  ' if ok else 'FAIL'} {label}", flush=True)
    if not ok:
        FAILED.append(label)


def recorded(on: bool):
    return spans.recording() if on else contextlib.nullcontext()


def median(xs):
    xs = [x for x in xs if x is not None]
    return statistics.median(xs) if xs else None


def card() -> dict:
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        smi = f"nvidia-smi: {e}"
    return {"card": torch.cuda.get_device_name(0), "nvidia_smi": smi,
            "torch": torch.__version__, "cuda": torch.version.cuda}


class DebugGraph(torch.cuda.CUDAGraph):
    """A ``CUDAGraph`` that keeps its graph (``keep_graph``) for
    ``debug_dump``."""

    def __new__(cls, keep_graph=True):
        return super().__new__(cls, keep_graph)

    def __init__(self, keep_graph=True):
        super().__init__(keep_graph)
        self.enable_debug_mode()


def nodes(graph) -> dict:
    """A captured ``DebugGraph``'s nodes and event-record nodes (None
    where the dump failed); then instantiates it, which a kept graph
    would otherwise do at its first replay."""
    try:
        with tempfile.TemporaryDirectory() as d:
            path = Path(d) / "graph.dot"
            graph.debug_dump(str(path))
            text = path.read_text()
    except (RuntimeError, OSError) as e:
        print(f"debug_dump: {e}", flush=True)
        return {"nodes": None, "event_records": None}
    finally:
        graph.instantiate()
    return {"nodes": len(set(re.findall(r'"(graph_\d+_node_\d+)"', text))),
            "event_records": len(re.findall(r"EVENT_?RECORD", text, re.IGNORECASE))}


def more_nodes(fewer: dict, more: dict, by: int) -> bool:
    """``more`` has ``by`` nodes more than ``fewer``, all of them event
    records, and ``fewer`` none."""
    return (None not in (fewer["nodes"], more["nodes"]) and fewer["event_records"] == 0
            and more["nodes"] - fewer["nodes"] == by == more["event_records"])


@contextlib.contextmanager
def deterministic():
    """Deterministic algorithms while open: two runs of one step give the
    same bits."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


def profiled(fn, dev):
    """``fn()`` once with recording on under ``torch.profiler``: (its
    result, the recording, the trace reduced as ``perfbench.trace.reduce``
    reduces it, device-idle ms by span)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from perfbench import trace

    torch.cuda.synchronize(dev)
    with spans.recording() as rec:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            with record_function(trace.WINDOW):
                out = fn()
                torch.cuda.synchronize(dev)
    events = prof.profiler.kineto_results.events()
    reduced = trace.reduce(events)
    idle = spans.idle_by_span(events, {s.name for s in rec.spans})
    return out, rec, reduced, idle


# -- events -----------------------------------------------------------------

def _two_phases(x):
    with spans.span("chip.gemms", x.device):
        y = x
        for _ in range(8):
            y = (y @ x) * x.shape[0] ** -0.5
    with spans.span("chip.reduce", x.device):
        return y.float().square().sum()


def _capture(x, on: bool):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _two_phases(x)
    torch.cuda.current_stream().wait_stream(side)
    g = DebugGraph()
    with recorded(on), spans.graph_phases() as phases, torch.cuda.graph(g):
        out = _two_phases(x)
    return g, phases, out


def events_phase(dev) -> dict:
    x = torch.randn(4096, 4096, device=dev, dtype=torch.bfloat16)
    g_off, phases_off, out_off = _capture(x, False)
    g_on, phases_on, out_on = _capture(x, True)
    n_off, n_on = nodes(g_off), nodes(g_on)
    expect(f"recording off captures no phase, recording on 2 event-record nodes a phase: "
           f"{n_off} -> {n_on}", not phases_off and len(phases_on) == 2
           and more_nodes(n_off, n_on, 4))
    rows = []
    with spans.recording() as rec:
        for _ in range(4):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            with spans.span("chip.replay"):
                g_on.replay()
                spans.replayed(phases_on)
            b.record()
            b.synchronize()
            rows.append({"around_ms": a.elapsed_time(b),
                         "lag_ms": a.elapsed_time(phases_on[0]._events[0])})
    got = [s for s in rec.spans if s.name.startswith("chip.") and s.name != "chip.replay"]
    for i, row in enumerate(rows):
        row.update({s.name: s.device_ms for s in got[2 * i:2 * i + 2]})
    g_off.replay()
    torch.cuda.synchronize()
    expect("the graph with phases computes the graph without them bit for bit",
           torch.equal(out_on, out_off))
    expect(f"each replay's phases read by elapsed_time, inside the events around it: {rows}",
           all(0 < r["chip.gemms"] and 0 < r["chip.reduce"]
               and r["chip.gemms"] + r["chip.reduce"] <= r["around_ms"] * 1.001
               and 0 <= r["lag_ms"] < r["around_ms"] for r in rows))
    del g_off, g_on
    return {"nodes_off": n_off, "nodes_on": n_on, "replays": rows,
            "train": small_train(dev), "serve": small_serve(dev)}


def small_train(dev) -> dict:
    """Reduced starcoder2-3b, 3 steps on each plan, captured with recording
    off and on: bit for bit alike, and the on graph's phases timed."""
    import dataclasses

    from repro_torch.configs import MeshConfig, ShapeConfig, get_config
    from repro_torch.core.advise import MemorySpace
    from repro_torch.core.residency import MemoryBudget, ResidencyPlan
    from repro_torch.core.streaming import offload_params
    from repro_torch.launch.step import _adamw_cfg, build_train_step
    from repro_torch.models import init_params
    from repro_torch.optim import init_state

    arch = get_config("starcoder2-3b")
    arch = dataclasses.replace(arch, model=arch.model.reduce())
    B, S = 2, 64
    shape = ShapeConfig("chip", S, B, "train")
    g = torch.Generator(device=dev).manual_seed(3)
    batches = [{"tokens": t, "labels": t.roll(-1, 1)} for t in
               (torch.randint(0, arch.model.vocab_size, (B, S), generator=g, device=dev,
                              dtype=torch.int32) for _ in range(4))]
    out = {}
    for host in (False, True):
        plan = (ResidencyPlan(arch.name, shape.name, MeshConfig(), MemoryBudget(),
                              opt_space=MemorySpace.HOST, int8_moments=True,
                              remat=arch.train.remat) if host else None)
        runs = {}
        for on in (False, True):
            params = init_params(arch.model, torch.Generator(device=dev).manual_seed(0), dev)
            state = init_state(params, _adamw_cfg(arch, plan))
            if host:
                state = offload_params(state, dev)
            step = build_train_step(arch, shape, None, plan, total_steps=10, device=dev)
            with recorded(on) as rec, deterministic():
                losses = [float(step(params, state, b, i + 1)[2]["loss"])
                          for i, b in enumerate(batches)]
            runs[on] = (losses, [p.detach().clone() for p in params.parameters()], rec)
            del step, state
        (l_off, p_off, _), (l_on, p_on, rec) = runs[False], runs[True]
        label = "host" if host else "card"
        steps = rec.named("train.step")
        phases = [[(c.name, c.device_ms) for c in rec.spans if c.parent is s] for s in steps]
        want = (["train.grads", "train.clip", "train.fetch", "train.update", "train.offload"]
                if host else ["train.grads", "train.clip", "train.update"])
        expect(f"reduced train, {label} plan: phases captured with recording on give the "
               f"same losses {l_on} and params bit for bit",
               l_on == l_off and all(torch.equal(a, b) for a, b in zip(p_on, p_off)))
        expect(f"reduced train, {label} plan: every step's phases {want} timed on the card, "
               "the first step's (eager) before its capture",
               [n for n, _ in phases[0]] == want + ["graph.capture"]
               and all([n for n, _ in ph] == want for ph in phases[1:])
               and all(ms > 0 for ph in phases for n, ms in ph if n != "graph.capture"))
        out[label] = {"losses": l_on, "step_ms": [s.ms for s in steps], "phases": phases}
    return out


def small_serve(dev) -> dict:
    """A reduced qwen2-7b serve call on the card with recording on."""
    from repro_torch.launch.serve import serve

    G = 6
    record = {}
    with spans.recording() as rec:
        serve("qwen2-7b", batch=2, prompt_len=16, gen=G, device=dev, record=record)
    (call,) = rec.named("serve.call")
    kinds = [s.attrs["kind"] for s in rec.named("graph.capture")]
    steps = rec.named("serve.step")
    expect(f"reduced serve: captures {kinds}, warm-up {len(rec.named('graph.warmup'))}, "
           f"{len(steps)} timed steps, counters {call.counts}",
           kinds == ["prefill", "decode"] and len(rec.named("graph.warmup")) == 1
           and len(steps) == G - 1 and all(s.device_ms > 0 for s in steps)
           and rec.named("prefill.layers")[0].device_ms > 0
           and set(call.counts) == {"alloc.device_mallocs", "alloc.device_frees"})
    expect("reduced serve: record read from the spans",
           record["prefill_ms"] == rec.named("serve.prefill")[0].ms
           and record["capture_ms"] == rec.named("serve.decode_capture")[0].ms)
    return {"record": record, "counts": call.counts,
            "step_device_ms": [s.device_ms for s in steps]}


# -- serve -------------------------------------------------------------------

def _serve_readings(rec) -> dict:
    """What one recording of serve calls reads, a list a call."""
    calls = rec.named("serve.call")

    def of(name, call, device=False):
        return [s.device_ms if device else s.ms for s in rec.spans
                if s.name == name and s.call == call.call]

    out = {"allocs": [sum(c.counts.values()) for c in calls], "counts": [c.counts for c in calls]}
    for name in ("serve.prefill", "serve.decode_capture", "prefill.logits"):
        out[name] = [sum(of(name, c)) for c in calls]
    out["serve.release"] = [of("serve.release", c) for c in calls]
    out["prefill.layers.device"] = [of("prefill.layers", c, True)[0] for c in calls]
    for kind in ("prefill", "decode"):
        out[f"graph.capture.{kind}"] = [
            s.ms for s in rec.named("graph.capture") if s.attrs["kind"] == kind]
    out["graph.warmup"] = [s.ms for s in rec.named("graph.warmup")]
    steps = [s.device_ms for s in rec.named("serve.step") if s.device_ms is not None]
    tokens = rec.named("serve.token")
    gaps = [(b.t0 - a.t0) / 1e6 for a, b in zip(tokens, tokens[1:]) if a.call == b.call]
    out.update({"serve.step.device_median": median(steps),
                "serve.step.device_p95": sorted(steps)[int(0.95 * (len(steps) - 1))]
                if steps else None,
                "serve.token.median": median([t.ms for t in tokens]),
                "token_gap_median": median(gaps)})
    return out


def serve_phase(seed: int, dev) -> dict:
    from perfbench import program, serve_cell, spec
    from perfbench import weights as W
    from perfbench.modelspec import spec_of
    from repro_torch.launch.serve import serve

    file = spec.load_config("qwen2-7b")
    m = spec_of("qwen2-7b", file)
    arch = program.arch_config(m, file)
    program.serve_config_matches(m, arch)
    params = program.load_params(m, arch.model, seed, dev)
    out = {}
    for name in ("decode", "prefill"):
        t = spec.load_traffic(name)
        B, P, G = t["batch"], t["prompt_len"], t["gen"]
        serve_cell.warm(arch, params, B, P, G, dev)
        index = [0]

        def call():
            prompts = [{"tokens": W.tokens(seed, "prompt", index[0], (B, P), m.vocab, dev)}]
            index[0] += 1
            t0 = time.perf_counter()
            serve(m.arch, reduced=False, batch=B, prompt_len=P, gen=G, seed=seed,
                  device=dev, params=params, prompts=prompts)
            return time.perf_counter() - t0

        times = {False: [], True: []}
        recs = []
        for on in ORDER:
            with recorded(on) as rec:
                times[on].append(call())
            if on:
                recs.append(rec)
        kept = spans.Recording()
        for rec in recs:  # the on calls' spans in one, call ids kept apart
            base = kept._calls
            for s in rec.spans:
                s.call += base
            kept._calls = base + rec._calls
            kept.spans += rec.spans
        per = B * (G if name == "decode" else P)
        row = {"call_s": {"off": times[False], "on": times[True]},
               "tokens_per_s": {k: [per / x for x in v] for k, v in
                                (("off", times[False]), ("on", times[True]))},
               "on_cost": median(times[True]) / median(times[False]) - 1,
               "spans": _serve_readings(kept)}
        _, prec, reduced, idle = profiled(call, dev)
        graph_idle = sum(idle.get(n, 0.0) for n in GRAPH_SPANS)
        window_ms, busy_ms = reduced["window_s"] * 1e3, reduced["busy_s"] * 1e3
        row["profiled"] = {"window_ms": window_ms, "busy_ms": busy_ms,
                           "idle_ms": window_ms - busy_ms, "idle_by_span": idle,
                           "graph_idle_ms": graph_idle, "idle_gaps": reduced["idle_gaps"],
                           "device_ops": reduced["device_ops"][:5],
                           "spans": _serve_readings(prec)}
        expect(f"{name}: graph_idle_ms {graph_idle:.1f} <= the call's idle "
               f"{window_ms - busy_ms:.1f}", graph_idle <= window_ms - busy_ms)
        if name == "decode":
            s = row["spans"]
            expect(f"decode: serve.step on the card {s['serve.step.device_median']:.2f} ms < "
                   f"the median token gap {s['token_gap_median']:.2f}",
                   s["serve.step.device_median"] < s["token_gap_median"])
        out[name] = row
        print(json.dumps({f"serve.{name}": row}), flush=True)
        serve_cell._free(dev)
    del params
    serve_cell._free(dev)
    return out


# -- train -------------------------------------------------------------------

PHASES = ("train.grads", "train.clip", "train.fetch", "train.update", "train.offload")


def train_phase(traffic: str, seed: int, dev) -> dict:
    from perfbench import spec, train_cell
    from perfbench import weights as W
    from perfbench.modelspec import spec_of
    from repro_torch.launch.step import GraphTrainStep

    file = spec.load_config("starcoder2-3b")
    m = spec_of("starcoder2-3b", file)
    t = spec.load_traffic(traffic)
    B, S, first = t["batch"], t["seq_len"], t["first_step"]
    real_graph, torch.cuda.CUDAGraph = torch.cuda.CUDAGraph, DebugGraph
    try:
        arch, params, state, step, _ = train_cell.build(m, file, t, seed, dev)
        n = [0]

        def run(step, on):
            batch = W.train_batch(seed, n[0], B, S, m.vocab, dev)
            with recorded(on) as rec:
                t0 = time.perf_counter()
                metrics = step(params, state, batch, first + n[0])[2]
                loss = float(metrics["loss"])
                ms = (time.perf_counter() - t0) * 1e3
            n[0] += 1
            return ms, rec, loss

        run(step, False)  # the capture, recording off
        nodes_plain = nodes(step.graph)
        plain = [run(step, False)[0] for _ in range(3)]
        body, opt_on_host = step.body, step.opt_on_host
        del step
        gc.collect()
        torch.cuda.empty_cache()
        step = GraphTrainStep(body, dev, opt_on_host)
        run(step, True)  # the capture, recording on: the phases become event nodes
        nodes_marked = nodes(step.graph)
    finally:
        torch.cuda.CUDAGraph = real_graph
    times, phases = {False: [], True: []}, []
    for on in ORDER:
        ms, rec, _ = run(step, on)
        times[on].append(ms)
        if on:
            phases.append({s.name: s.device_ms for s in rec.spans if s.name in PHASES})
    (_, _, loss), prec, reduced, idle = profiled(lambda: run(step, False), dev)
    prof_phases = {s.name: s.device_ms for s in prec.spans if s.name in PHASES}
    busy_ms, copy_ms = reduced["busy_s"] * 1e3, reduced["host_copy_s"] * 1e3
    phase_sum = sum(prof_phases.values())
    row = {"step_ms": {"plain_graph_off": plain, "marked_graph_off": times[False],
                       "marked_graph_on": times[True]},
           "on_cost": median(times[True]) / median(plain) - 1,
           "nodes": {"plain": nodes_plain, "marked": nodes_marked},
           "phases": phases,
           "phases_median": {k: median([p[k] for p in phases]) for k in phases[0]},
           "profiled": {"phases": prof_phases, "phase_sum_ms": phase_sum, "busy_ms": busy_ms,
                        "window_ms": reduced["window_s"] * 1e3, "host_copy_ms": copy_ms,
                        "idle_by_span": idle, "idle_gaps": reduced["idle_gaps"],
                        "loss": loss}}
    expect(f"{traffic}: the marked graph has {len(prof_phases)} phases x 2 event nodes more: "
           f"{nodes_plain} -> {nodes_marked}",
           more_nodes(nodes_plain, nodes_marked, 2 * len(prof_phases)))
    expect(f"{traffic}: the phases' sum {phase_sum:.1f} ms within 3 % of the step's busy "
           f"{busy_ms:.1f}", abs(phase_sum - busy_ms) <= 0.03 * busy_ms)
    if "train.fetch" in prof_phases:
        moved = prof_phases["train.fetch"] + prof_phases["train.offload"]
        expect(f"{traffic}: fetch + offload {moved:.1f} ms within 10 % of the step's host "
               f"copies {copy_ms:.1f}", abs(moved - copy_ms) <= 0.1 * copy_ms)
    print(json.dumps({traffic: row}), flush=True)
    del step, params, state
    gc.collect()
    torch.cuda.empty_cache()
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="events,serve,train,offload")
    ap.add_argument("--seed", type=int, default=2_654_435_761)
    ap.add_argument("--out", type=Path, help="a JSON file to write the phases to")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_spans: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    out = {"device": card(), "seed": args.seed}
    print(json.dumps(out), flush=True)
    phases = {"events": lambda: events_phase(dev), "serve": lambda: serve_phase(args.seed, dev),
              "train": lambda: train_phase("train", args.seed, dev),
              "offload": lambda: train_phase("train-offload", args.seed, dev)}
    for name in args.phases.split(","):
        t0 = time.perf_counter()
        out[name] = phases[name]()
        out[f"{name}_s"] = time.perf_counter() - t0
        print(json.dumps({name: out[name]}) if name == "events" else f"{name}: "
              f"{out[f'{name}_s']:.1f} s", flush=True)
        if args.out is not None:
            args.out.parent.mkdir(parents=True, exist_ok=True)
            args.out.write_text(json.dumps(out, indent=1))
    if FAILED:
        print(f"chip_spans: {len(FAILED)} checks failed: {FAILED}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
