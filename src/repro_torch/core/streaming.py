"""Layer-weight streaming + remat policies (host-tier oversubscription).

The counterpart of ``repro.core.streaming``.  ``fetch_params`` copies
parameters that a ResidencyPlan places in HOST space to the card at their
point of use; from pinned memory the copies are asynchronous on the current
stream, so they overlap what the host queues next.  ``offload_params``
evicts them to pinned host memory; ``offload_into`` writes them back into
the pinned tensors they were fetched from.

Where the caller runs on the CPU there is no host tier: the copies are
identities and the plan is carried analytically, as in the reference.

``remat_policy`` and ``checkpoint_layer`` keep the reference's policies.
Its "offload" offloads only the tensors named "residual", and no layer of
either package names one, so "offload" recomputes as "full" does and
keeps every saved tensor on the card.
"""
from __future__ import annotations

import functools

import torch
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.core.placement import _pinned_copy, backend_supports_memory_kinds
from repro_torch.device import resolve

REMAT_KINDS = ("none", "dots", "full", "offload")
# the matrix products whose outputs "dots" keeps for the backward pass
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
         torch.ops.aten.bmm.default)


def _map_tensors(fn, tree):
    """``fn`` on every tensor of ``tree``; a DTensor's local shard is moved
    and rewrapped with the same mesh and placements."""
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tensors(fn, v) for v in tree)
    if isinstance(tree, DTensor):
        out = fn(tree.to_local())
        if not isinstance(out, torch.Tensor):
            return out
        return DTensor.from_local(out, tree.device_mesh, tree.placements,
                                  run_check=False, shape=tree.shape, stride=tree.stride())
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def fetch_params(tree, device=None):
    """Host->device fetch of a tree of tensors (dicts, lists, tuples) on the
    current stream; asynchronous for pinned sources.  ``device=None`` is
    the card and raises without one; on the CPU it is the identity."""
    dev = resolve(device)
    if not backend_supports_memory_kinds(dev):
        return tree
    return _map_tensors(lambda x: x.to(dev, non_blocking=True), tree)


def offload_params(tree, device=None):
    """Device->host eviction of a tree of tensors into pinned memory: every
    copy is issued on the current stream, then the stream is waited for
    once, so the host copies can be read at once.  Identity on the CPU."""
    dev = resolve(device)
    if not backend_supports_memory_kinds(dev):
        return tree
    out = _map_tensors(_pinned_copy, tree)
    torch.cuda.current_stream(dev).synchronize()
    return out


def offload_into(dst, src):
    """Device->host eviction of ``src``, a tree that ``fetch_params`` made
    from ``dst``, back into ``dst``'s own tensors (pinned memory): each copy
    is issued on the current stream and none is waited for, so the caller
    waits for the stream before it reads ``dst`` on the host.  A tensor that
    is its own source (the CPU's fetch is the identity) is left as it is; a
    DTensor's local shard is written.  Returns ``dst``.  Unlike
    ``offload_params`` it allocates nothing and does not synchronise, so a
    CUDA graph can capture it."""
    if isinstance(dst, dict):
        for k, d in dst.items():
            offload_into(d, src[k])
    elif isinstance(dst, (list, tuple)):
        for d, s in zip(dst, src, strict=True):
            offload_into(d, s)
    elif isinstance(dst, torch.Tensor) and dst is not src:
        if isinstance(dst, DTensor):
            dst, src = dst.to_local(), src.to_local()
        dst.copy_(src, non_blocking=True)
    return dst


def _save_all(ctx, op, *args, **kwargs):
    return CheckpointPolicy.MUST_SAVE


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _save_nothing(ctx, op, *args, **kwargs):
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_policy(kind: str):
    """Activation-residency policy, as a selective-checkpoint policy
    function (what the forward pass keeps for the backward pass).

    - "none": save everything (no remat)
    - "dots": save the outputs of the matrix products (``mm``, ``addmm``,
      ``bmm``), recompute the rest
    - "full": save nothing; recompute (the standard big-model choice)
    - "offload": the reference's ``save_and_offload_only_these_names(
      names_which_can_be_saved=[], names_which_can_be_offloaded=
      ["residual"])``: save nothing, offload to pinned host memory only the
      tensors named "residual", recompute the rest.  No layer names a
      tensor "residual", so this is "full"'s policy on every device
    """
    if kind not in REMAT_KINDS:
        raise ValueError(f"unknown remat policy {kind!r}")
    if kind == "none":
        return _save_all
    if kind == "dots":
        return _save_dots
    return _save_nothing


def checkpoint_layer(fn, kind: str):
    """``fn`` under remat policy ``kind``: "none" is ``fn`` itself, "full"
    and "offload" (which saves and offloads nothing, ``remat_policy``) are
    ``torch.utils.checkpoint`` (non-reentrant), the same operations and so
    the same bits, and "dots" is selective checkpointing with
    ``remat_policy("dots")``.  The checkpoints keep no RNG state
    (``preserve_rng_state=False``): no layer draws random numbers, and the
    compiled train step captures the recompute in a CUDA graph."""
    policy = remat_policy(kind)  # raises on an unknown name
    if kind == "none":
        return fn

    @functools.wraps(fn)
    def wrapped(*args):
        if kind == "dots":
            return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                              context_fn=functools.partial(
                                  create_selective_checkpoint_contexts, policy))
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)

    return wrapped
