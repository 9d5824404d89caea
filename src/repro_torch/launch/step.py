"""Step builders: the counterparts of ``repro.launch.step``: train_step /
prefill_step / serve_step for every family, on one device or on a mesh,
plus ``input_specs()`` and the other abstract inputs (tensors on the
``meta`` device, the counterparts of ``jax.ShapeDtypeStruct``) and
``make_shardings``.

The modality frontends are STUBS per the brief: ``[audio]`` gets token
codebook grids shaped like EnCodec output; ``[vlm]`` gets precomputed patch
embeddings + (t,h,w) M-RoPE position streams.

The ResidencyPlan threads through the train step: remat policy, int8
moments, and the optimizer state's placement (pinned host memory, fetched
to the card for the update and written back into the same pinned tensors
after it).

On a mesh the parameters are DTensors placed by ``param_specs`` and the
optimizer state by ``opt_specs`` (``place_train_state``); the batch is
placed by ``batch_specs`` and the model runs under ``mesh_context``, where
its ``shard_hint``s redistribute the activations.  After backward a
gradient is ``Partial`` over the batch axes; it is reduced to its
parameter's placement (2d, fsdp) or to its optimizer state's (zero1), the
counterparts of the reference's gradient sharding constraints.

With no mesh the serve step is a ``GraphServeStep``: on a card, one CUDA
graph replayed a token, the counterpart of the reference's
``jax.jit(build_serve_step(arch))``; the prefill step is a
``GraphPrefillStep``: one layer's CUDA graph replayed over the layers, the
counterpart of the reference's ``jax.jit`` of its scan over the layers;
the train step is a ``GraphTrainStep``: the whole step, optimizer
included, in one CUDA graph that updates the state in place, the
counterpart of the reference's ``jax.jit`` with donation.
"""
from __future__ import annotations

import contextlib

import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch import spans
from repro_torch.checkpoint.checkpointer import tree_leaves
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.advise import MemorySpace
from repro_torch.core.residency import ResidencyPlan
from repro_torch.core.streaming import fetch_params, offload_into
from repro_torch.device import resolve, same_device
from repro_torch.launch.mesh import mesh_context
from repro_torch.launch.sharding import (
    batch_specs,
    cache_specs,
    distribute_module,
    distribute_opt_state,
    opt_specs,
    param_specs,
)
from repro_torch.models import transformer as tf
from repro_torch.models.common import get_param_mode, spec_placements
from repro_torch.optim import (
    AdamWConfig,
    apply_updates,
    clip_by_global_norm,
    init_state,
    warmup_cosine,
)

META = torch.device("meta")


# ---------------------------------------------------------------------------
# Abstract inputs (the dry-run's stand-ins: meta tensors, no allocation)
# ---------------------------------------------------------------------------

def input_specs(arch: ArchConfig, shape: ShapeConfig, device=META) -> dict:
    cfg = arch.model
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    bf16 = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32

    def sds(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=device)

    if shape.kind in ("train", "prefill"):
        if cfg.family == "audio":
            batch = {
                "tokens": sds((B, S, cfg.num_codebooks), i32),
                "labels": sds((B, S, cfg.num_codebooks), i32),
            }
        elif cfg.family == "vlm":
            batch = {
                "embeds": sds((B, S, cfg.d_model), bf16),    # stub frontend
                "labels": sds((B, S), i32),
                "positions_thw": sds((B, S, 3), i32),
            }
        else:
            batch = {"tokens": sds((B, S), i32), "labels": sds((B, S), i32)}
        if shape.kind == "prefill":
            batch.pop("labels", None)
        return batch

    # decode: KV cache of seq_len, one new token
    if cfg.family == "audio":
        return {"tokens": sds((B, cfg.num_codebooks), i32)}
    return {"tokens": sds((B,), i32)}


def abstract_caches(arch: ArchConfig, shape: ShapeConfig, device=META) -> dict:
    return tf.init_caches(arch.model, shape.global_batch, shape.seq_len, device=device)


def abstract_params(arch: ArchConfig, device=META) -> tf.Transformer:
    return tf.Transformer(arch.model, device)


def abstract_opt_state(arch: ArchConfig, plan: ResidencyPlan | None = None,
                       device=META) -> dict:
    return init_state(abstract_params(arch, device), _adamw_cfg(arch, plan))


def _adamw_cfg(arch: ArchConfig, plan: ResidencyPlan | None) -> AdamWConfig:
    int8 = plan.int8_moments if plan is not None else arch.train.int8_moments
    return AdamWConfig(
        weight_decay=arch.train.weight_decay,
        int8_moments=int8,
        master_dtype=arch.train.master_dtype,
    )


# ---------------------------------------------------------------------------
# Shardings
# ---------------------------------------------------------------------------

def make_shardings(arch: ArchConfig, shape: ShapeConfig, mesh,
                   plan: ResidencyPlan | None = None):
    """DTensor placements for (params, opt_state, batch, caches), each a
    dict keyed like the tree it places (opt_state: {"leaves": {name:
    {key: placements}}}; the step counter stays a plain tensor).  The
    plan's host placement is not a placement: the train step fetches and
    offloads the state's local shards."""
    cfg = arch.model
    params = abstract_params(arch)
    params_sh = {n: spec_placements(s, mesh) for n, s in param_specs(cfg, params).items()}

    opt_sh = None
    if shape.kind == "train":
        ospecs = opt_specs(cfg, params)
        abs_opt = abstract_opt_state(arch, plan)
        opt_sh = {"leaves": {
            n: {k: spec_placements(ospecs[n] if v.ndim else (), mesh) for k, v in leaf.items()}
            for n, leaf in abs_opt["leaves"].items()}}

    bspecs = batch_specs(cfg, mesh, shape.kind, shape.global_batch)
    batch_sh = {k: spec_placements(v, mesh) for k, v in bspecs.items()}

    caches_sh = None
    if shape.kind == "decode":
        cspecs = cache_specs(cfg, mesh, shape.global_batch)
        caches_sh = {k: spec_placements(cspecs[k], mesh) for k in abstract_caches(arch, shape)}
    return params_sh, opt_sh, batch_sh, caches_sh


def place_train_state(arch: ArchConfig, params, opt_state, mesh, mode: str | None = None):
    """Place a ``Transformer`` (in place) and its ``init_state`` state on
    ``mesh``: parameters by ``param_specs``, masters and moments by
    ``opt_specs``.  Returns (params, opt_state)."""
    cfg = arch.model
    state = distribute_opt_state(opt_state, cfg, params, mesh, mode)
    distribute_module(params, param_specs(cfg, params, mode), mesh)
    return params, state


def place_batch(arch: ArchConfig, batch: dict, mesh, kind: str) -> dict:
    """The global batch (the same plain tensors on every rank) placed by
    ``batch_specs``."""
    specs = batch_specs(arch.model, mesh, kind, next(iter(batch.values())).shape[0])
    return {k: v if isinstance(v, DTensor) else
            distribute_tensor(v, mesh, spec_placements(specs.get(k, ()), mesh))
            for k, v in batch.items()}


def place_caches(arch: ArchConfig, caches: dict, mesh) -> dict:
    """Decode caches (stacked, leading L) placed by ``cache_specs``."""
    specs = cache_specs(arch.model, mesh, next(iter(caches.values())).shape[1])
    return {k: distribute_tensor(v, mesh, spec_placements(specs[k], mesh))
            for k, v in caches.items()}


def _reduce_grad(g, want):
    """The reduction of a gradient to ``want``: a ``Partial`` becomes a sum
    over its mesh dims (all-reduce or reduce-scatter)."""
    return g.redistribute(g.device_mesh, want)


def _scalar(x):
    """A 0-d result as a plain tensor (a DTensor's whole value)."""
    return x.full_tensor() if isinstance(x, DTensor) else x


# ---------------------------------------------------------------------------
# Steps
# ---------------------------------------------------------------------------

def build_train_step(arch: ArchConfig, shape: ShapeConfig, mesh=None,
                     plan: ResidencyPlan | None = None, *, total_steps: int = 10_000,
                     device=None):
    """Returns train_step(params, opt_state, batch, step) -> (params,
    opt_state, metrics) for a ``Transformer`` and a state of
    ``optim.init_state`` on ``device`` (default: the card; raises without
    one).  The parameters and the state are updated in place; with the
    plan's optimizer on the host, ``opt_state`` stays in pinned memory: the
    step fetches it to the card and writes the update back into the same
    tensors, and waits for the card before it returns.

    With no mesh the step is a ``GraphTrainStep`` under every plan (remat
    "offload" recomputes as "full" does, ``core/streaming.py``): on a card
    the whole step in one CUDA graph, the counterpart of the reference's
    ``jax.jit`` with donation.  A ``mesh`` keeps the eager step, as the
    reference runs no compiled sharded step: params and state placed by
    ``place_train_state``, and ``batch`` the global batch (plain tensors,
    the same on every rank), which each microbatch takes by ``batch_specs``.

    Gradients: with one microbatch in the parameters' dtype, as the
    reference's; with ``microbatches`` > 1 summed over the microbatches in
    fp32 buffers and divided by their number.  Metrics: ``loss``,
    ``grad_norm`` (before clipping) and ``lr``, as plain 0-d tensors.

    The step's phases are spans (``repro_torch.spans``), timed on the card:
    ``train.grads``, ``train.clip``, ``train.update``, and with the state on
    the host ``train.fetch`` before the update and ``train.offload`` after.
    """
    cfg = arch.model
    dev = resolve(device if mesh is None else mesh.device_type)
    acfg = _adamw_cfg(arch, plan)
    remat = plan.remat if plan is not None else arch.train.remat
    micro = max(1, min(arch.train.microbatches, shape.global_batch))
    opt_on_host = plan is not None and plan.opt_space is MemorySpace.HOST
    grad_specs = None
    if mesh is not None:
        # ZeRO-1: gradients reduce-scatter into the optimizer's (data-added)
        # sharding; otherwise into the parameters' own
        specs = (opt_specs if get_param_mode() == "zero1" else param_specs)(
            cfg, abstract_params(arch))
        grad_specs = {n: spec_placements(s, mesh) for n, s in specs.items()}

    def grads_of(params, names, leaves, mb):
        loss = tf.loss_fn(params, mb, cfg, remat=remat)
        grads = torch.autograd.grad(loss, leaves)
        if grad_specs is not None:
            grads = [_reduce_grad(g, grad_specs[n]) for n, g in zip(names, grads)]
        return loss.detach(), grads

    def place(mb):
        return mb if mesh is None else place_batch(arch, mb, mesh, "train")

    def train_step(params, opt_state, batch, step):
        lr = warmup_cosine(step, peak_lr=arch.train.learning_rate,
                           warmup_steps=arch.train.warmup_steps,
                           total_steps=total_steps)
        names, leaves = zip(*params.named_parameters())
        with spans.span("train.grads", dev):
            if micro == 1:
                loss, grads = grads_of(params, names, leaves, place(batch))
            else:
                acc = None
                loss = 0.0
                for i in range(micro):
                    mb = {k: v.reshape((micro, v.shape[0] // micro) + v.shape[1:])[i]
                          for k, v in batch.items()}
                    l, g = grads_of(params, names, leaves, place(mb))
                    if acc is None:  # fp32 buffers: 0 + g, exactly g
                        acc = [x.to(torch.float32) for x in g]
                    else:
                        for a, x in zip(acc, g):
                            a += x
                    loss = loss + l
                    del g
                grads = [a / micro for a in acc]
                del acc
                loss = loss / micro
        with spans.span("train.clip", dev):
            grads, gnorm = clip_by_global_norm(dict(zip(names, grads)), arch.train.grad_clip)
        if opt_on_host:
            with spans.span("train.fetch", dev):
                on_card = fetch_params(opt_state, dev)      # host -> card
            with spans.span("train.update", dev):
                apply_updates(params, grads, on_card, acfg, lr)
            with spans.span("train.offload", dev):
                offload_into(opt_state, on_card)            # card -> the same host tensors
        else:
            with spans.span("train.update", dev):
                apply_updates(params, grads, opt_state, acfg, lr)
        return params, opt_state, {"loss": _scalar(loss), "grad_norm": _scalar(gnorm),
                                   "lr": lr}

    if mesh is None:
        return GraphTrainStep(train_step, dev, opt_on_host)

    def eager_train_step(params, opt_state, batch, step):
        with mesh_context(mesh) if mesh is not None else contextlib.nullcontext():
            out = train_step(params, opt_state, batch, step)
        _await_host(dev, opt_on_host)
        return out

    return eager_train_step


def _graph_capture(graph):
    """``torch.cuda.graph`` for ``graph`` and the stream it captures on:
    torch's one capture stream, on which a step warms up too.  A new stream
    for each step would keep a cuBLAS workspace of its own for the rest of
    the process."""
    capture = torch.cuda.graph(graph)
    return capture, capture.capture_stream


def _await_host(dev: torch.device, opt_on_host: bool) -> None:
    """With the optimizer state on the host, wait for the card: the step's
    copies back into the pinned state are asynchronous, and the caller may
    read it on the host at once."""
    if opt_on_host and dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()


class GraphTrainStep:
    """The one-device train step: the lr (``warmup_cosine``), the loss and
    its gradients under the config's remat (microbatches accumulated in
    fp32), the clipping and the AdamW update, with the plan's fetch and
    offload, captured in one ``torch.cuda.CUDAGraph`` and replayed at every
    call, as the reference runs ``jax.jit(step, donate_argnums=(0, 1))``.

    ``body(params, opt_state, batch, step)`` is the step's computation,
    which the graph captures; called directly it is the eager step (no wait
    for the card).  The parameters and the optimizer state are updated in
    place, the counterpart of the reference's donation: a call returns
    ``(params, opt_state, metrics)`` with the objects it was given.  With
    the state on the host the body copies the update back into the pinned
    tensors it fetched, and the call waits for the card before it returns.

    The graph reads static buffers, one per batch tensor and the step as a
    0-d int32 on the card, which each call fills first (``fill_`` for an
    int, ``copy_`` for a tensor), so the lr is computed from the step in
    the graph.  The first call runs the body eagerly on a side stream,
    which stands as that step's result, releases the cached blocks the
    warm-up left, and captures the body on that stream, which executes
    nothing; every later call is one ``replay()``.  ``capture_ms`` is the
    capture's host time (the device synchronised before and after; 0.0 on
    the CPU).  The metrics (``loss``, ``grad_norm``, ``lr``) are 0-d outputs
    of the graph, which the next replay rewrites.

    Spans: ``train.step`` (fill, capture or replay, wait) and
    ``graph.capture`` (``kind="train"``, ``capture_ms``).  The body's phase
    spans are captured only when a recording is open at the capture, as
    timing-event nodes of the graph, whose times each replay then enters as
    spans (``spans.replayed``); with none open the graph has no such node.

    From its first call the step is bound to the params and state objects
    and the tensors they hold, and to the batch's keys, shapes and dtypes:
    a call with others raises.  It never re-captures and never falls back
    to the eager step.  On the CPU it runs the body eagerly on the same
    buffers in place of a replay.
    """

    def __init__(self, body, device, opt_on_host: bool):
        self.body, self.device, self.opt_on_host = body, torch.device(device), opt_on_host
        self.graph = self.metrics = None
        self.capture_ms = 0.0
        self._bound = None
        self._phases = []

    @staticmethod
    def _pointers(params, opt_state) -> tuple:
        return tuple(x.data_ptr() for x in tree_leaves((params, opt_state)))

    def _bind(self, params, opt_state, batch) -> None:
        """Binds the step at its first call; later, raises for inputs other
        than those it is bound to."""
        spec = {k: (tuple(v.shape), v.dtype) for k, v in batch.items()}
        if self._bound is None:
            dev = next(params.parameters()).device
            if not same_device(dev, self.device):
                raise ValueError(f"train step: the params are on {dev}, the step on "
                                 f"{self.device}")
            self._bound = (params, opt_state, self._pointers(params, opt_state), spec)
            self._batch = {k: torch.empty_like(v, device=dev) for k, v in batch.items()}
            self._step = torch.zeros((), dtype=torch.int32, device=dev)
            return
        bound_params, bound_state, pointers, bound_spec = self._bound
        if (params is not bound_params or opt_state is not bound_state
                or self._pointers(params, opt_state) != pointers):
            raise ValueError("train step: bound to other params or optimizer state")
        if spec != bound_spec:
            raise ValueError(f"train step: bound to a batch of {bound_spec}, given {spec}")

    def _fill(self, batch, step) -> None:
        for k, v in batch.items():
            self._batch[k].copy_(v)
        if isinstance(step, torch.Tensor):
            self._step.copy_(step)
        else:
            self._step.fill_(step)

    def _capture(self, params, opt_state) -> dict:
        """The first step computed on a side stream (the warm-up), then the
        body captured on that stream; returns the first step's metrics."""
        dev = self.device
        graph = torch.cuda.CUDAGraph()
        capture, side = _graph_capture(graph)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            first = self.body(params, opt_state, self._batch, self._step)[2]
        torch.cuda.synchronize(dev)
        # the warm-up's transients, else the graph's pool holds a second copy
        torch.cuda.empty_cache()
        with spans.span("graph.capture", kind="train") as timed, \
                spans.graph_phases() as self._phases:
            with capture:
                self.metrics = self.body(params, opt_state, self._batch, self._step)[2]
            torch.cuda.synchronize(dev)
        self.capture_ms = timed.ms
        self.graph = graph
        for k, v in first.items():
            self.metrics[k].copy_(v)
        return self.metrics

    def __call__(self, params, opt_state, batch, step):
        self._bind(params, opt_state, batch)
        with spans.span("train.step"):
            self._fill(batch, step)
            if self.device.type != "cuda":
                metrics = self.body(params, opt_state, self._batch, self._step)[2]
            elif self.graph is None:
                metrics = self._capture(params, opt_state)
            else:
                self.graph.replay()
                spans.replayed(self._phases)
                metrics = self.metrics
            _await_host(self.device, self.opt_on_host)
        return params, opt_state, dict(metrics)


def _copy_by_dtype(dst, src) -> None:
    """dst[j].copy_(src[j]) for every j: one ``_foreach_copy_`` a dtype,
    whose list of a single dtype takes the multi-tensor kernel."""
    groups: dict = {}
    for d, s in zip(dst, src, strict=True):
        to, frm = groups.setdefault(d.dtype, ([], []))
        to.append(d)
        frm.append(s)
    for to, frm in groups.values():
        torch._foreach_copy_(to, frm)


class GraphPrefillStep:
    """The one-device prefill step: one layer's prefill
    (``tf.prefill_layer``) captured once in a ``torch.cuda.CUDAGraph`` and
    replayed over the layers, as the reference runs ``jax.jit`` of its
    ``lax.scan`` over the stacked layers.

    The graph runs on a slot layer (a block built uninitialised on the
    card) and static buffers for x and the positions; it ends by writing
    the new x into its x buffer.  Before each replay one
    ``_foreach_copy_`` a dtype copies that layer's weights into the slot;
    after it the layer's cache outputs, which the next replay rewrites,
    are copied into stacked (L, ...) caches at the layer's index.  The
    embedding, the final norm and the logits run eagerly.

    The first call captures: it warms the body up on a side stream with
    layer 0's own computation, which stands as layer 0's result, then
    captures the body on that stream, which executes nothing.  The graph
    is bound to the batch's keys, shapes and dtypes and to ``cfg``: a call
    with another batch raises, as do params that are not cfg's
    ``num_layers`` blocks of the slot's names, shapes and dtypes.  It is
    not bound to the params, whose values are copied in at every call.
    Nothing re-captures or falls back to the eager prefill.

    A call returns (next tokens, caches), as the reference's prefill step
    does; ``logits`` holds the last position's logits and ``capture_ms``
    the capture's host time (the device synchronised before and after,
    ``torch.cuda.graph``'s own garbage collection and cache release
    included; 0.0 on the CPU), the span ``graph.capture``
    (``kind="prefill"``).  Spans: ``prefill.layers`` (the weight loads,
    layers and cache copies, the capture inside the first call's; timed on
    the card too) and ``prefill.logits``.  The step runs on the params' device;
    params on the CPU take the same slot path, the body called eagerly in
    place of a replay.
    """

    def __init__(self, cfg):
        self.cfg = cfg
        self.graph = self.logits = self.slot = None
        self.capture_ms = 0.0

    def _layers(self, params, batch) -> list:
        """Each block's parameters, in the slot's order, after the checks
        of the batch and the params against what the step is bound to; the
        slot is built at the first call."""
        dev = params.embedding.device
        spec = {k: (tuple(v.shape), v.dtype) for k, v in batch.items()}
        if self.slot is None:
            self.slot, self._spec = tf.new_block(self.cfg, dev), spec
            self._names, self._weights = zip(*self.slot.named_parameters())
        elif spec != self._spec:
            raise ValueError(f"prefill step: bound to a batch of {self._spec}, given {spec}")
        if len(params.blocks) != self.cfg.num_layers:
            raise ValueError(f"prefill step: bound to {self.cfg.num_layers} layers, the "
                             f"params have {len(params.blocks)}")
        layers = []
        for blk in params.blocks:
            names, weights = zip(*blk.named_parameters())
            if names != self._names or any(
                    w.shape != s.shape or w.dtype != s.dtype or w.device != s.device
                    for w, s in zip(weights, self._weights)):
                raise ValueError("prefill step: a block's parameters differ in names, shapes, "
                                 "dtypes or device from the config's layer")
            layers.append(weights)
        return layers

    def _load(self, weights) -> None:
        """The slot takes one layer's weights."""
        _copy_by_dtype(self._weights, weights)

    def _capture(self, x, positions):
        """Layer 0 computed on a side stream (the warm-up), then the body
        captured on that stream; returns layer 0's (x, cache)."""
        dev, cfg = x.device, self.cfg
        self._x, self._positions = x.clone(), positions.clone()
        graph = torch.cuda.CUDAGraph()
        capture, side = _graph_capture(graph)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            first = tf.prefill_layer(self.slot, self._x, self._positions, cfg)
        torch.cuda.synchronize(dev)
        with spans.span("graph.capture", kind="prefill") as timed:
            with capture:
                out, self._cache = tf.prefill_layer(self.slot, self._x, self._positions, cfg)
                self._x.copy_(out)
            torch.cuda.synchronize(dev)
        self.capture_ms = timed.ms
        self.graph = graph
        self._x.copy_(first[0])
        return self._x, first[1]

    def _layer(self, i, x, positions):
        """Layer i on the slot: (x, cache)."""
        if x.device.type != "cuda":
            return tf.prefill_layer(self.slot, x, positions, self.cfg)
        if self.graph is None:
            return self._capture(x, positions)
        if i == 0:
            self._x.copy_(x)
            self._positions.copy_(positions)
        self.graph.replay()
        return self._x, self._cache

    @torch.no_grad()
    def __call__(self, params, batch):
        layers = self._layers(params, batch)
        x, positions = tf.embed_inputs(params, batch, self.cfg)
        caches = None
        with spans.span("prefill.layers", x.device):
            for i, weights in enumerate(layers):
                self._load(weights)
                x, cache = self._layer(i, x, positions)
                if caches is None:
                    caches = {k: v.new_empty((len(layers),) + v.shape) for k, v in cache.items()}
                _copy_by_dtype([caches[k][i] for k in cache], cache.values())
        with spans.span("prefill.logits"):
            self.logits = tf.prefill_logits(params, x, self.cfg)
        return self.logits.argmax(dim=-1), caches


def build_prefill_step(arch: ArchConfig, mesh=None):
    """prefill_step(params, batch) -> (next tokens, caches).  With no mesh a
    ``GraphPrefillStep`` on the params' device, one layer's CUDA graph
    replayed over the layers on a card; on a mesh the eager ``tf.prefill``,
    the batch placed by ``batch_specs`` and the tokens coming back whole."""
    cfg = arch.model
    if mesh is None:
        return GraphPrefillStep(cfg)

    def prefill_step(params, batch):
        with mesh_context(mesh):
            logits, caches = tf.prefill(params, place_batch(arch, batch, mesh, "prefill"), cfg)
            return _scalar(logits).argmax(dim=-1), caches

    return prefill_step


GRAPH_WARMUP = 2  # eager steps on scratch caches before a capture


class GraphServeStep:
    """The one-device serve step: the greedy decode (``decode_step`` and
    ``argmax``) captured in one ``torch.cuda.CUDAGraph`` and replayed at
    every call, as the reference runs ``jax.jit(build_serve_step(arch))``.

    ``capture`` (or the first call) warms the step up on a side stream
    against scratch clones of the caches (it writes them, so on the real
    ones rwkv's and hymba's recurrent states would advance a token too
    far), then captures it on that stream, which executes nothing.  The
    graph reads static buffers, one per batch tensor and ``cache_len`` as a
    0-d int32, which each call fills before the replay.  It is bound to the
    params and the cache tensors it was captured on: a call with others
    raises, and nothing re-captures or falls back to the eager step.  A
    call returns (next tokens, caches), the tokens in a buffer that every
    replay rewrites; ``logits`` is the step's logits, rewritten likewise.

    Caches on the CPU take the eager step, which sets ``logits`` too.
    ``device``: None follows the caches; a device makes any other raise.
    The capture is the span ``graph.capture`` (``kind="decode"``), its
    warm-up the child span ``graph.warmup``.
    """

    def __init__(self, cfg, device=None):
        self.cfg = cfg
        self.device = None if device is None else torch.device(device)
        self.graph = self.logits = None

    def _device_of(self, caches) -> torch.device:
        dev = next(iter(caches.values())).device
        if self.device is not None and not same_device(dev, self.device):
            raise ValueError(f"serve step: the caches are on {dev}, the step on {self.device}")
        return dev

    def _fill(self, batch, cache_len) -> None:
        for k, v in batch.items():
            self._batch[k].copy_(v)
        if isinstance(cache_len, torch.Tensor):
            self._cache_len.copy_(cache_len)
        else:
            self._cache_len.fill_(cache_len)

    def capture(self, params, batch, caches, cache_len) -> None:
        """Capture the step at these inputs' shapes on these params and
        caches, which it leaves as they were; on the CPU, nothing."""
        dev = self._device_of(caches)
        if dev.type != "cuda":
            return
        if self.graph is not None:
            raise RuntimeError("serve step: captured already; a step holds one graph")
        self._params, self._caches = params, dict(caches)
        self._batch = {k: torch.empty_like(v) for k, v in batch.items()}
        self._cache_len = torch.empty((), dtype=torch.int32, device=dev)
        self._fill(batch, cache_len)
        with spans.span("graph.capture", kind="decode"):
            graph = torch.cuda.CUDAGraph()
            capture, side = _graph_capture(graph)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side), spans.span("graph.warmup"):
                scratch = {k: v.clone() for k, v in caches.items()}
                for _ in range(GRAPH_WARMUP):
                    tf.decode_step(params, self._batch, scratch, self._cache_len, self.cfg)
                del scratch
            torch.cuda.current_stream(dev).wait_stream(side)
            with capture:
                logits, _ = tf.decode_step(params, self._batch, caches, self._cache_len,
                                           self.cfg)
                nxt = logits.argmax(dim=-1)
        self.graph, self.logits, self._next = graph, logits, nxt

    def __call__(self, params, batch, caches, cache_len):
        if self._device_of(caches).type != "cuda":
            self.logits, caches = tf.decode_step(params, batch, caches, cache_len, self.cfg)
            return self.logits.argmax(dim=-1), caches
        if self.graph is None:
            self.capture(params, batch, caches, cache_len)
        if (params is not self._params or caches.keys() != self._caches.keys()
                or any(caches[k].data_ptr() != c.data_ptr() or caches[k].shape != c.shape
                       for k, c in self._caches.items())):
            raise ValueError("serve step: its graph was captured on other params or caches")
        if batch.keys() != self._batch.keys() or any(
                v.shape != self._batch[k].shape for k, v in batch.items()):
            raise ValueError(f"serve step: the batch must hold {tuple(self._batch)} of "
                             f"the captured shapes")
        self._fill(batch, cache_len)
        self.graph.replay()
        return self._next, caches


def build_serve_step(arch: ArchConfig, mesh=None, *, device=None):
    """One-token decode step: greedy sample + cache update (in place),
    ``(next tokens, caches)``.  With no mesh a ``GraphServeStep`` on
    ``device`` (default: the caches' device), captured as a CUDA graph on a
    card; on a mesh the eager step, the caches placed by ``place_caches``,
    the tokens by ``batch_specs``, and the sampled tokens come back whole."""
    cfg = arch.model
    if mesh is None:
        return GraphServeStep(cfg, device)

    def serve_step(params, batch, caches, cache_len):
        with mesh_context(mesh):
            logits, caches = tf.decode_step(params, place_batch(arch, batch, mesh, "decode"),
                                            caches, cache_len, cfg)
            return _scalar(logits).argmax(dim=-1), caches

    return serve_step


__all__ = [
    "GraphPrefillStep", "GraphServeStep", "GraphTrainStep", "abstract_caches",
    "abstract_opt_state", "abstract_params", "build_prefill_step", "build_serve_step",
    "build_train_step", "input_specs", "make_shardings", "place_batch", "place_caches",
    "place_train_state",
]
