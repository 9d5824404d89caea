"""Continuous-batching LM inference over the UM simulator (DESIGN.md §13):
the port's copy of ``repro.umbench.serving.scheduler``.

A saxml-style serving loop: requests are admitted FCFS against a KV *token
budget* (and a ``max_live_batches`` cap), prefilled, and then join the
running batch — one decode kernel per step advances every live request by
one token, requests join and leave the batch between steps, and a finished
request's KV blocks are freed (``sim.free``) so their device residency is
handed back.

KV-to-UM mapping: each live request's KV cache is a *growing set* of UM
regions — one region for the prompt KV (written by the prefill kernel) plus
``kv_block_tokens``-sized generation blocks allocated as decoding crosses
block boundaries.  Decode kernels read the weights shard and every live KV
block; new blocks populate device-side on first touch (virgin faults — KV
is produced on the GPU, never host-initialized), and under KV
oversubscription the LRU churn between the live requests' blocks is exactly
the thrash regime the memory tiers differentiate on.

The variant axis plugs in through three strategy hooks
(``serving_stage``/``serving_admit``/``serving_step``, see
``umbench.variants``) plus the shared ``on_alloc`` — the scheduler itself
is tier-agnostic, like the workload lowering template.

Model sizing comes from ``repro_torch.configs``: the named arch fixes
``kv_bytes_per_token`` (layers x kv-heads x head-dim), while the modeled
weights shard is ``weights_frac`` of device memory (a TP-sharded deployment
— the full 72B checkpoint would drown a 16 GB card's KV signal entirely),
and per-token flops follow from that shard so decode stays memory-bound the
way real decode is.

Everything is deterministic: arrivals come pre-generated from
``traffic.py``, the loop is pure Python over the simulator's deterministic
clocks, and the simulated clock doubles as the wall clock (idle gaps jump
``sim.t_device`` to the next arrival).
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import get_config
from repro_torch.core.simulator import UMSimulator
from repro_torch.umbench import workload as wk
from repro_torch.umbench.serving.traffic import Request


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Scheduler knobs; ``arch`` names a ``repro_torch.configs`` model."""

    arch: str = "qwen2-72b"
    dtype_bytes: int = 2            # KV/weights element width (bf16)
    weights_frac: float = 0.25      # weights shard, as fraction of device mem
    kv_block_tokens: int = 512      # generation-block granularity
    max_live_batches: int = 64      # hard cap on the running batch

    def kv_bytes_per_token(self) -> int:
        return get_config(self.arch).model.kv_bytes_per_token(self.dtype_bytes)


@dataclasses.dataclass(frozen=True)
class ServedRequest:
    """The per-request timeline the metrics layer aggregates — every field
    in simulated seconds on the device-stream clock."""

    rid: int
    arrival_s: float
    admit_s: float
    prefill_done_s: float
    finish_s: float
    prompt_len: int
    gen_len: int


@dataclasses.dataclass
class _Live:
    req: Request
    admit_s: float
    blocks: list[str]
    prefill_done_s: float = 0.0
    generated: int = 0              # tokens decoded so far
    gen_capacity: int = 0           # tokens the allocated gen blocks hold


class ContinuousBatchScheduler:
    """One serving trace through one simulator under one variant strategy.

    ``kv_frac`` sets the admission token budget to that fraction of the
    device memory *left after the weights shard* — at 1.0 the live KV plus
    weights exactly fills the device (the at-capacity baseline), at 1.5/2.0
    the aggregate KV of admitted requests oversubscribes it and the UM tier
    under test has to manage the eviction traffic.
    """

    def __init__(self, sim: UMSimulator, strategy, config: ServingConfig,
                 kv_frac: float):
        self.sim = sim
        self.strategy = strategy
        self.cfg = config
        self.kv_b = config.kv_bytes_per_token()
        self.weights_bytes = int(config.weights_frac * sim.device_capacity)
        kv_budget = int(kv_frac * (sim.device_capacity - self.weights_bytes))
        self.token_budget = max(1, kv_budget // self.kv_b)
        # per-token flops follow from the *modeled* shard (2 flops/param)
        self.flops_per_token = 2.0 * (self.weights_bytes / config.dtype_bytes)
        self.n_decode_steps = 0
        self.n_prefills = 0

    # -- region lifecycle ------------------------------------------------------
    def _alloc_block(self, name: str, nbytes: int) -> None:
        self.sim.alloc(name, nbytes, role="kv")
        self.strategy.on_alloc(self.sim, wk.Alloc(name, int(nbytes), "kv"))
        self.strategy.serving_admit(self.sim, name)

    def _prefill(self, lr: _Live) -> None:
        req = lr.req
        name = f"kv/{req.rid}/0"
        self._alloc_block(name, req.prompt_len * self.kv_b)
        lr.blocks = [name]
        self.sim.kernel(f"prefill/{req.rid}",
                        flops=self.flops_per_token * req.prompt_len,
                        reads=["weights"], writes=[name])
        lr.prefill_done_s = self.sim.t_device
        self.n_prefills += 1

    def _grow_kv(self, lr: _Live) -> None:
        """Allocate the next generation block when the current ones are
        full — the growing-region half of the KV-to-UM mapping."""
        if lr.generated < lr.gen_capacity:
            return
        ntok = min(self.cfg.kv_block_tokens, lr.req.gen_len - lr.gen_capacity)
        name = f"kv/{lr.req.rid}/{len(lr.blocks)}"
        self._alloc_block(name, ntok * self.kv_b)
        lr.blocks.append(name)
        lr.gen_capacity += ntok

    def _retire(self, lr: _Live, done: list[ServedRequest]) -> None:
        for name in lr.blocks:
            self.sim.free(name)
        done.append(ServedRequest(
            rid=lr.req.rid, arrival_s=lr.req.arrival_s, admit_s=lr.admit_s,
            prefill_done_s=lr.prefill_done_s, finish_s=self.sim.t_device,
            prompt_len=lr.req.prompt_len, gen_len=lr.req.gen_len))

    # -- the loop --------------------------------------------------------------
    def run(self, requests: tuple[Request, ...]) -> list[ServedRequest]:
        sim, cfg = self.sim, self.cfg
        sim.alloc("weights", self.weights_bytes, role="weights")
        self.strategy.on_alloc(
            sim, wk.Alloc("weights", self.weights_bytes, "weights"))
        sim.host_write("weights")   # checkpoint load
        self.strategy.serving_stage(sim, "weights")

        queue = sorted(requests, key=lambda r: (r.arrival_s, r.rid))
        qi = 0
        live: list[_Live] = []
        live_tokens = 0
        done: list[ServedRequest] = []
        while qi < len(queue) or live:
            if not live:
                # idle: the serving clock jumps to the next arrival
                sim.t_device = max(sim.t_device, queue[qi].arrival_s)
            now = sim.t_device
            # FCFS admission against the token budget (no reordering: a
            # request that does not fit blocks the ones behind it); an empty
            # batch admits unconditionally so an oversized request cannot
            # deadlock the queue — it simply oversubscribes alone
            while qi < len(queue) and queue[qi].arrival_s <= now:
                req = queue[qi]
                if live and (live_tokens + req.total_tokens > self.token_budget
                             or len(live) >= cfg.max_live_batches):
                    break
                qi += 1
                lr = _Live(req, admit_s=sim.t_device, blocks=[])
                live_tokens += req.total_tokens
                self._prefill(lr)
                live.append(lr)
            if not live:
                continue
            # one decode step: every live request advances by one token
            for lr in live:
                self._grow_kv(lr)
            kv_names = [b for lr in live for b in lr.blocks]
            self.strategy.serving_step(sim, kv_names)
            sim.kernel("decode",
                       flops=self.flops_per_token * len(live),
                       reads=["weights"] + kv_names, writes=[])
            self.n_decode_steps += 1
            still = []
            for lr in live:
                lr.generated += 1
                if lr.generated >= lr.req.gen_len:
                    live_tokens -= lr.req.total_tokens
                    self._retire(lr, done)
                else:
                    still.append(lr)
            live = still
        return done


def serve(sim: UMSimulator, strategy, requests: tuple[Request, ...],
          kv_frac: float,
          config: ServingConfig | None = None) -> ContinuousBatchScheduler:
    """Run one serving trace; returns the scheduler with ``.served`` (the
    completed :class:`ServedRequest` list) attached for the metrics layer."""
    sched = ContinuousBatchScheduler(sim, strategy, config or ServingConfig(),
                                     kv_frac)
    sched.served = sched.run(requests)
    return sched
