"""A serving cell: ``repro_torch.launch.serve.serve`` in a closed loop with
one client, calls back to back until the window's seconds have passed (the
window ends with the last call).  Each call serves a fresh batch of
prompts made from the seed with the weights made once in set-up.

The traffic file gives ``batch``, ``prompt_len``, ``gen`` and
``sample_rows``, the rows (prompt and served tokens) that the reference
checks after the window.  Set-up warms the call's own shapes through the
same step builders a call uses: one prefill, the re-homing of its caches,
one decode capture and two replays.

A token's time is when the host has it: each decode step is read back
before the next is called, so the serve step that ``serve`` gets from
``launch.serve.build_serve_step`` is wrapped, and the wrapper stamps the
time its capture or a step call is entered.  The first token is read by
the call's first stamp, whichever it is (so a step captured every call,
once for all calls, or never is timed alike), the token before each step
call after the first by its stamp, and the last token by the call's return.  A
call that does not stamp one step call for each token after the first
fails the run.
"""
from __future__ import annotations

import random
import sys
import time

import torch

from perfbench import bounds, check, program, trace
from perfbench import weights as W
from perfbench.reference import model as ref_model
from perfbench.reference.precision import FP32, exact_fp32


class _Stamped:
    """A serve step that stamps the host clock at its capture and calls."""

    def __init__(self, step, marks: list):
        self._step, self._marks = step, marks

    def capture(self, *args, **kwargs):
        self._marks.append(("capture", time.perf_counter()))
        return self._step.capture(*args, **kwargs)

    def __call__(self, *args, **kwargs):
        self._marks.append(("step", time.perf_counter()))
        return self._step(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._step, name)


class TokenClock:
    """While open, ``launch.serve``'s serve steps are stamped."""

    def __enter__(self):
        from repro_torch.launch import serve as serve_mod

        self.mod, self.real, self.marks = serve_mod, serve_mod.build_serve_step, []

        def build(arch, mesh=None, *, device=None):
            return _Stamped(self.real(arch, mesh, device=device), self.marks)

        serve_mod.build_serve_step = build
        return self

    def __exit__(self, *exc):
        self.mod.build_serve_step = self.real

    def token_times(self, gen: int, end: float) -> list[float]:
        """The host times of a call's ``gen`` tokens: its first stamp
        (a capture or a step call), the stamps of step calls 2.., the
        return."""
        marks, self.marks[:] = list(self.marks), []
        steps = [t for kind, t in marks if kind == "step"]
        if gen > 1 and len(steps) != gen - 1:
            raise RuntimeError(f"the serve call stamped {len(steps)} steps, not {gen - 1}: "
                               "its decode did not go through build_serve_step")
        return [marks[0][1]] + steps[1:] + [end] if gen > 1 else [end]


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def warm(arch, params, batch: int, prompt: int, gen: int, dev) -> None:
    """The call's shapes, once, through the builders a call uses."""
    from repro_torch.launch.serve import rehome_caches
    from repro_torch.launch.step import build_prefill_step, build_serve_step

    ids = torch.zeros((batch, prompt), dtype=torch.int32, device=dev)
    prefill = build_prefill_step(arch)
    nxt, caches = prefill(params, {"tokens": ids})
    caches = rehome_caches(arch.model, caches, batch, prompt + gen, dev)
    del prefill
    step = build_serve_step(arch, device=dev)
    n = torch.tensor(prompt, dtype=torch.int32, device=dev)
    step.capture(params, {"tokens": nxt.to(torch.int32)}, caches, n)
    for _ in range(2):
        step(params, {"tokens": nxt.to(torch.int32)}, caches, n)
    _sync(dev)
    del step, caches


def run(m, file: dict, traffic: dict, seed: int, seconds: float, traced: bool, dev,
        t_start: float) -> tuple[dict, dict]:
    """(facts for the metric readers, the numbers compared)."""
    from repro_torch.launch.serve import serve

    B, P, G = traffic["batch"], traffic["prompt_len"], traffic["gen"]
    arch = program.arch_config(m, file)
    program.serve_config_matches(m, arch)
    params = program.load_params(m, arch.model, seed, dev)
    warm(arch, params, B, P, G, dev)
    _sync(dev)

    calls = []

    def call(index: int) -> dict:
        rec = {}
        t0 = time.perf_counter()
        out = serve(m.arch, reduced=False, batch=B, prompt_len=P, gen=G, seed=seed,
                    device=dev, params=params, record=rec,
                    prompts=[{"tokens": W.tokens(seed, "prompt", index, (B, P), m.vocab, dev)}])
        end = time.perf_counter()
        return {"index": index, "tokens": out, "times": clock.token_times(G, end),
                "call_s": end - t0, "prefill_ms": rec["prefill_ms"],
                "capture_ms": rec["prefill_capture_ms"] + rec["capture_ms"]}

    with TokenClock() as clock:
        t_open = time.perf_counter()
        while not calls or time.perf_counter() - t_open < seconds:
            calls.append(call(len(calls)))
        window_s = time.perf_counter() - t_open
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        profile = trace.profiled(lambda: call(len(calls)), dev) if traced else None

    print("calls (s, prefill ms, capture ms): " + " ".join(
        f"{c['call_s']:.3f}/{c['prefill_ms']:.0f}/{c['capture_ms']:.0f}" for c in calls),
        file=sys.stderr)
    served = [c["tokens"] for c in calls]
    failed = sum(int(t.shape != (B, G) or t.min() < 0 or t.max() >= m.vocab) for t in served)
    facts = {
        "kind": "serve", "setup_s": t_open - t_start, "window_s": window_s,
        "generated": len(calls) * B * G, "prompt_tokens": len(calls) * B * P,
        "calls": len(calls),
        "gaps_ms": [1e3 * (b - a) for c in calls for a, b in zip(c["times"], c["times"][1:])],
        "prefill_ms": [c["prefill_ms"] for c in calls],
        "capture_ms": [c["capture_ms"] for c in calls],
        "call_bound_s": bounds.serve_call_bound_s(m, B, P, G),
        "trace": profile, "memory_peak_bytes": peak,
        "attempted": len(calls) * B, "failed": failed * B,
        "served_calls": [{"index": c["index"], "tokens": c["tokens"]} for c in calls],
    }
    del params
    _free(dev)
    rows = sample(seed, len(calls), B, traffic["sample_rows"])
    t_ref = time.perf_counter()
    numbers = {"logit_gap": served_gap(m, seed, traffic, calls, rows, dev)}
    print(f"reference: {len(rows)} rows in {time.perf_counter() - t_ref:.1f} s", file=sys.stderr)
    return facts, numbers


def sample(seed: int, n_calls: int, batch: int, k: int) -> list[tuple[int, int]]:
    """``k`` (call, row) pairs of the window's, drawn from the seed (every
    row is as long as the longest)."""
    rng = random.Random(W.seed_of(seed, "sample"))
    pairs = [(c, r) for c in range(n_calls) for r in range(batch)]
    return sorted(rng.sample(pairs, min(k, len(pairs))))


def rows_of(m, seed: int, traffic: dict, calls: list, rows: list, dev):
    """The sampled rows' prompts (made again from the seed) followed by
    their served tokens: (ids (k, P + G), served (k, G))."""
    B, P = traffic["batch"], traffic["prompt_len"]
    prompts = {c: W.tokens(seed, "prompt", c, (B, P), m.vocab, dev) for c in {c for c, _ in rows}}
    served = torch.stack([torch.as_tensor(calls[c]["tokens"][r]) for c, r in rows]).to(dev)
    ids = torch.cat([torch.stack([prompts[c][r] for c, r in rows]), served.to(torch.int32)], 1)
    return ids, served


def served_gap(m, seed: int, traffic: dict, calls: list, rows: list, dev) -> float:
    """The widest gap of a sampled served token below the reference's best."""
    exact_fp32()
    ids, served = rows_of(m, seed, traffic, calls, rows, dev)
    P = traffic["prompt_len"]
    logits = ref_model.served_logits(m, seed, ids[:, :-1], P - 1, FP32, traffic["ref_block_rows"])
    return float(check.logit_gaps(logits, served).max())


def _free(dev) -> None:
    import gc

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
