"""A training cell: the port's compiled train step
(``repro_torch.launch.step.build_train_step``, one device, no mesh) step
after step on batches made from the seed, until the window's seconds have
passed (the window ends with the last step, whose loss is read on the
host, as ``train()`` reads each step's).

The traffic file gives ``batch``, ``seq_len``, ``first_step`` (the step
number of the first call: the lr is the schedule's there), ``plan``
("card": the state on the card; "host": int8 moments and the optimizer
state in pinned host memory, placed by ``core.streaming.offload_params``,
with the configuration's remat) and ``checked_steps``.  ``train()`` is not
driven: it checkpoints every 20 steps and cannot take the host plan.

Set-up builds the step, its params and state once and drives them through
the first ``checked_steps`` steps, which the first call captures; it reads
the losses, the first gradient's norm a leaf from the optimizer's state
after one step, and each leaf's change after the last, and hands the same
objects to the window.  After the window the reference follows those
steps from the seed's weights and batches.

With ``--trace 1``, after the window: the next step under the profiler
(``trace.profiled``; its shape is ``traced_call``), then the optimizer
alone (``optimizer_ms``).  No step is recorded inside the program's
``spans.recording()``: no reader reads a train span yet (``spans`` None).
"""
from __future__ import annotations

import math
import statistics
import sys
import time

import torch

from perfbench import bounds, check, program, trace
from perfbench import weights as W
from perfbench.reference import train as ref_train
from perfbench.reference.precision import FP32, exact_fp32


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def build(m, file: dict, traffic: dict, seed: int, dev):
    """(arch, params, state, step, AdamW config) of the port."""
    from repro_torch.configs import MeshConfig, ShapeConfig
    from repro_torch.core.advise import MemorySpace
    from repro_torch.core.residency import MemoryBudget, ResidencyPlan
    from repro_torch.core.streaming import offload_params
    from repro_torch.launch.step import build_train_step
    from repro_torch.optim import AdamWConfig, init_state

    arch = program.arch_config(m, file)
    shape = ShapeConfig("perfbench", traffic["seq_len"], traffic["batch"], "train")
    host = traffic["plan"] == "host"
    plan = (ResidencyPlan(arch.name, shape.name, MeshConfig(), MemoryBudget(),
                          opt_space=MemorySpace.HOST, int8_moments=True,
                          remat=arch.train.remat) if host else None)
    acfg = AdamWConfig(weight_decay=arch.train.weight_decay, int8_moments=host,
                       master_dtype=arch.train.master_dtype)
    params = program.load_params(m, arch.model, seed, dev)
    state = init_state(params, acfg)
    if host:
        state = offload_params(state, dev)
    step = build_train_step(arch, shape, None, plan, total_steps=file["train"]["total_steps"],
                            device=dev)
    return arch, params, state, step, acfg


@torch.no_grad()
def grad_norms(state: dict, b1: float, dev) -> dict[str, float]:
    """The first gradient's norm a leaf, m / (1 - b1), from the state after
    one step (fetched leaf by leaf where it is on the host)."""
    out = {}
    for k, s in state["leaves"].items():
        mo = s["m"].to(dev).to(torch.float32)
        if "m_scale" in s:
            mo = mo * s["m_scale"].to(dev)
        out[k] = torch.linalg.vector_norm(mo) / (1 - b1)
    return {k: float(v) for k, v in zip(out, torch.stack(list(out.values())).tolist())}


def change_norms(m, seed: int, state: dict, dev) -> dict[str, float]:
    """Each leaf's change since the seed's weights, from its fp32 master
    (the rows of the padded vocabulary left out)."""
    now = {k: s["master"][:m.vocab] if k in ("embedding", "lm_head") else s["master"]
           for k, s in state["leaves"].items()}
    return ref_train.initial_norm_gap(m, seed, now, dev)


def run(m, file: dict, traffic: dict, seed: int, seconds: float, traced: bool, dev,
        t_start: float) -> tuple[dict, dict]:
    """(facts for the metric readers, the numbers compared)."""
    B, S, first = traffic["batch"], traffic["seq_len"], traffic["first_step"]
    arch, params, state, step, acfg = build(m, file, traffic, seed, dev)

    def batch(i: int) -> dict:
        return W.train_batch(seed, i, B, S, m.vocab, dev)

    prog = {"losses": []}
    for i in range(traffic["checked_steps"]):
        params, state, metrics = step(params, state, batch(i), first + i)
        prog["losses"].append(float(metrics["loss"]))
        if i == 0:
            prog["grad_norms"] = grad_norms(state, acfg.b1, dev)
    prog["change_norms"] = change_norms(m, seed, state, dev)
    _sync(dev)

    losses, n = [], traffic["checked_steps"]
    t_open = time.perf_counter()
    ends = []
    while not losses or ends[-1] - t_open < seconds:
        params, state, metrics = step(params, state, batch(n), first + n)
        losses.append(float(metrics["loss"]))
        ends.append(time.perf_counter())
        n += 1
    window_s = ends[-1] - t_open
    print("step s (host clock): " + " ".join(
        f"{b - a:.4f}" for a, b in zip([t_open] + ends, ends)), file=sys.stderr)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    facts = {
        "kind": "train", "setup_s": t_open - t_start, "window_s": window_s,
        "steps": len(losses), "trained_tokens": len(losses) * B * S,
        "step_flops": bounds.train_step_flops(m, B, S), "memory_peak_bytes": peak,
        "attempted": len(losses),
        "failed": sum(1 for x in losses if not math.isfinite(x)),
        "spec": m, "traced_call": None, "trace": None, "optimizer_ms": None, "spans": None,
    }
    if traced:
        facts["traced_call"] = {"batch": B, "seq_len": S}
        facts["trace"] = trace.profiled(lambda: step(params, state, batch(n), first + n), dev)
    del step, metrics
    if traced:
        facts["optimizer_ms"] = optimizer_ms(arch, params, state, acfg, batch(n + 1),
                                            first + n + 1, file["train"]["total_steps"], dev)
    del params, state
    _free(dev)
    exact_fp32()
    t_ref = time.perf_counter()
    ref = ref_train.run(m, file["train"], seed, batch, traffic["checked_steps"], first,
                        traffic["plan"] == "host", dev, FP32, traffic["ref_block_rows"])
    print(f"reference: {traffic['checked_steps']} steps in {time.perf_counter() - t_ref:.1f} s",
          file=sys.stderr)
    gaps = check.train_gaps(prog, ref)
    print(f"worst gaps: {check.worst(gaps)}", file=sys.stderr)
    for k, _ in check.worst(gaps)["change_gap"]:
        print(f"  {k}: change {prog['change_norms'][k]!r} / {ref['change_norms'][k]!r}, "
              f"first gradient {prog['grad_norms'][k]!r} / {ref['grad_norms'][k]!r}",
              file=sys.stderr)
    return facts, check.train_numbers(gaps)


def optimizer_ms(arch, params, state, acfg, batch, step_no: int, total_steps: int,
                 dev) -> float:
    """The optimizer alone, eager, as the step runs it: the clip and
    ``apply_updates`` on fresh gradients (the host plan's state fetched to
    the card first, not timed); the median of 3 timed by CUDA events
    after one warm-up."""
    from repro_torch.core.streaming import fetch_params
    from repro_torch.models import transformer as tf
    from repro_torch.optim import apply_updates, clip_by_global_norm, warmup_cosine

    _free(dev)
    names, leaves = zip(*params.named_parameters())
    loss = tf.loss_fn(params, batch, arch.model, remat=arch.train.remat)
    grads = dict(zip(names, torch.autograd.grad(loss, leaves)))
    del loss
    on_card = fetch_params(state, dev)
    lr = warmup_cosine(torch.tensor(step_no, device=dev), peak_lr=arch.train.learning_rate,
                       warmup_steps=arch.train.warmup_steps, total_steps=total_steps)

    def opt():
        clip_by_global_norm(grads, arch.train.grad_clip)
        apply_updates(params, grads, on_card, acfg, lr)

    opt()
    times = []
    for _ in range(3):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        opt()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    del grads, on_card
    return statistics.median(times)


def _free(dev) -> None:
    import gc

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
