"""A serving cell: ``repro_torch.launch.serve.serve`` in a closed loop with
one client, calls back to back until the window's seconds have passed and
the last round is whole (the window ends with the last call).  Each call
serves a fresh batch of prompts made from the seed with the weights made
once in set-up.

The traffic file gives ``batch``, ``prompt_len``, ``gen`` and
``sample_rows``, the rows (prompt and served tokens) that the reference
checks after the window.  ``gen`` is a number; ``batch`` and
``prompt_len`` are each a number or ``{"shuffled": [...]}``.  Lists are
of one length, a round of calls, and give call after call their values
at one place (a list of batches beside one of lengths pairs them), every
place once a round in an order drawn from the seed and the round
(``call_shape``).  The window holds whole rounds: every seed, and every
speed of the program, serves the same mix of shapes.  Set-up warms the
round's call of the most tokens through the same step builders a call
uses: one prefill, the re-homing of its caches, one decode capture and
two replays.

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


SHAPES = ("batch", "prompt_len", "gen")
DRAWN = ("batch", "prompt_len")  # the shapes a list may give


def _values(traffic: dict, key: str) -> list[int]:
    """The values of one shape: a number's one, or a ``shuffled`` list."""
    spec = traffic[key]
    if isinstance(spec, int):
        return [spec]
    if key not in DRAWN or not isinstance(spec, dict) or list(spec) != ["shuffled"]:
        raise ValueError(f"{key}: {spec!r}; a shape is a number, and batch or prompt_len "
                         'may be {"shuffled": [...]}')
    return list(spec["shuffled"])


def round_shapes(traffic: dict) -> list[dict[str, int]]:
    """The shapes of one round's calls, in the file's order: the lists'
    values at each place (the lists are of one length)."""
    values = {key: _values(traffic, key) for key in SHAPES}
    lengths = {len(v) for v in values.values()} - {1}
    if len(lengths) > 1:
        raise ValueError(f"the shuffled lists differ in length: {sorted(lengths)}")
    n = lengths.pop() if lengths else 1
    return [{key: v[i] if len(v) > 1 else v[0] for key, v in values.items()} for i in range(n)]


def call_shape(traffic: dict, seed: int, index: int) -> dict[str, int]:
    """Call ``index``'s batch, prompt length and generated tokens: a shape
    of the round, the round's order drawn from the seed and the round."""
    shapes = round_shapes(traffic)
    rnd, at = divmod(index, len(shapes))
    order = list(range(len(shapes)))
    random.Random(W.seed_of(seed, "shape", "round", rnd)).shuffle(order)
    return shapes[order[at]]


def largest_shape(traffic: dict) -> dict[str, int]:
    """The round's call of the most tokens (the longest prompt of those)."""
    return max(round_shapes(traffic),
               key=lambda s: (s["batch"] * (s["prompt_len"] + s["gen"]), s["prompt_len"]))


def run(m, file: dict, traffic: dict, seed: int, seconds: float, traced: bool, dev,
        t_start: float) -> tuple[dict, dict]:
    """(facts for the metric readers, the numbers compared)."""
    from repro_torch.launch.serve import serve

    arch = program.arch_config(m, file)
    program.serve_config_matches(m, arch)
    params = program.load_params(m, arch.model, seed, dev)
    top = largest_shape(traffic)
    warm(arch, params, top["batch"], top["prompt_len"], top["gen"], dev)
    _sync(dev)

    calls = []

    def call(index: int) -> dict:
        rec, shape = {}, call_shape(traffic, seed, index)
        B, P, G = shape["batch"], shape["prompt_len"], shape["gen"]
        t0 = time.perf_counter()
        out = serve(m.arch, reduced=False, batch=B, prompt_len=P, gen=G, seed=seed,
                    device=dev, params=params, record=rec,
                    prompts=[{"tokens": W.tokens(seed, "prompt", index, (B, P), m.vocab, dev)}])
        end = time.perf_counter()
        return {"index": index, **shape, "tokens": out, "times": clock.token_times(G, end),
                "call_s": end - t0, "prefill_ms": rec["prefill_ms"],
                "capture_ms": rec["prefill_capture_ms"] + rec["capture_ms"]}

    with TokenClock() as clock:
        t_open = time.perf_counter()
        per_round = len(round_shapes(traffic))
        while not calls or len(calls) % per_round or time.perf_counter() - t_open < seconds:
            calls.append(call(len(calls)))
        window_s = time.perf_counter() - t_open
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        profile = trace.profiled(lambda: call(len(calls)), dev) if traced else None

    print("calls (B x P + G, s, prefill ms, capture ms): " + " ".join(
        f"{c['batch']}x{c['prompt_len']}+{c['gen']}/{c['call_s']:.3f}/{c['prefill_ms']:.0f}/"
        f"{c['capture_ms']:.0f}" for c in calls), file=sys.stderr)
    failed = sum(c["batch"] for c in calls
                 if c["tokens"].shape != (c["batch"], c["gen"]) or c["tokens"].min() < 0
                 or c["tokens"].max() >= m.vocab)
    facts = {
        "kind": "serve", "setup_s": t_open - t_start, "window_s": window_s,
        "generated": sum(c["batch"] * c["gen"] for c in calls),
        "prompt_tokens": sum(c["batch"] * c["prompt_len"] for c in calls),
        "calls": len(calls),
        "gaps_ms": [1e3 * (b - a) for c in calls for a, b in zip(c["times"], c["times"][1:])],
        "prefill_ms": [c["prefill_ms"] for c in calls],
        "capture_ms": [c["capture_ms"] for c in calls],
        "call_bound_s": [bounds.serve_call_bound_s(m, c["batch"], c["prompt_len"], c["gen"])
                         for c in calls],
        "trace": profile, "memory_peak_bytes": peak,
        "attempted": sum(c["batch"] for c in calls), "failed": failed,
        "served_calls": [{k: c[k] for k in ("index", "tokens") + SHAPES} for c in calls],
    }
    del params
    _free(dev)
    rows = sample(seed, calls, traffic["sample_rows"])
    t_ref = time.perf_counter()
    numbers = {"logit_gap": served_gap(m, seed, traffic, calls, rows, dev)}
    print(f"reference: {len(rows)} rows in {time.perf_counter() - t_ref:.1f} s", file=sys.stderr)
    return facts, numbers


def sample(seed: int, calls: list, k: int) -> list[tuple[int, int]]:
    """``k`` (call, row) pairs of the window's ``calls``, drawn from the
    seed; where calls differ in length, one of the longest is among them."""
    rng = random.Random(W.seed_of(seed, "sample"))
    pairs = [(c, r) for c, call in enumerate(calls) for r in range(call["batch"])]
    picked = rng.sample(pairs, min(k, len(pairs)))
    length = [call["prompt_len"] + call["gen"] for call in calls]
    if all(length[c] < max(length) for c, _ in picked):
        picked[-1] = rng.choice([(c, r) for c, r in pairs if length[c] == max(length)])
    return sorted(picked)


def rows_of(m, seed: int, calls: list, rows: list, dev):
    """The sampled rows' prompts (made again from the seed at their call's
    shape) followed by their served tokens, ended with zeros up to the
    longest: (ids (k, longest), [(first logit's position, served (G,))])."""
    longest = max(calls[c]["prompt_len"] + calls[c]["gen"] for c, _ in rows)
    ids = torch.zeros((len(rows), longest), dtype=torch.int32, device=dev)
    served = []
    for i, (c, r) in enumerate(rows):
        call = calls[c]
        P, G = call["prompt_len"], call["gen"]
        ids[i, :P] = W.tokens(seed, "prompt", c, (call["batch"], P), m.vocab, dev)[r]
        ids[i, P:P + G] = torch.as_tensor(call["tokens"][r]).to(dev)
        served.append((P - 1, ids[i, P:P + G]))
    return ids, served


def reference_logits(m, seed: int, ids, served: list, mm, block_rows: int) -> list:
    """Each sampled row's logits (G, vocab) at the positions its served
    tokens were chosen, the reference run over ``ids`` (causal: a row's
    trailing zeros change none of them)."""
    first = min(p for p, _ in served)
    logits = ref_model.served_logits(m, seed, ids[:, :-1], first, mm, block_rows)
    return [logits[i, p - first:p - first + len(t)] for i, (p, t) in enumerate(served)]


def served_gap(m, seed: int, traffic: dict, calls: list, rows: list, dev) -> float:
    """The widest gap of a sampled served token below the reference's best."""
    exact_fp32()
    ids, served = rows_of(m, seed, calls, rows, dev)
    logits = reference_logits(m, seed, ids, served, FP32, traffic["ref_block_rows"])
    return max(float(check.logit_gaps(x, t).max()) for x, (_, t) in zip(logits, served))


def _free(dev) -> None:
    import gc

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
