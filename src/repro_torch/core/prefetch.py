"""Prefetch — the cudaMemPrefetchAsync analogue (paper §II-C).

The counterpart of ``repro.core.prefetch``.  Host->HBM: ``PrefetchIterator``
keeps ``depth`` batches in flight (the copy of batch k+1 is issued while
batch k computes), and ``streaming.fetch_params`` moves layer weights.

As in the paper, the transfers are *bulk* (one ``cudaMemcpyAsync`` per
array from pinned memory, at the link's full rate) and *asynchronous*: on a
CUDA device they run on a side stream, and the consumer's stream waits on
each batch's copy event only when the batch is handed over.  A NumPy batch
is first copied into a pinned staging buffer; that copy is synchronous and
runs on the host thread that pulls the batch.
"""
from __future__ import annotations

import collections
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from repro_torch.core.placement import backend_supports_memory_kinds
from repro_torch.device import resolve


def _map(fn, tree, path=()):
    """``fn(path, leaf)`` over the leaves of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def _host_tensor(leaf):
    """A CPU tensor sharing ``leaf``'s memory, or None for a non-array leaf."""
    if isinstance(leaf, torch.Tensor):
        return leaf
    if isinstance(leaf, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(leaf))
    return None


class _Slot:
    """Pinned staging buffers for one batch in flight, and the event of the
    copy that last read them."""

    def __init__(self):
        self.buffers: dict = {}
        self.event: torch.cuda.Event | None = None

    def stage(self, path, src: torch.Tensor) -> torch.Tensor:
        buf = self.buffers.get(path)
        if buf is None or buf.shape != src.shape or buf.dtype != src.dtype:
            buf = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
            self.buffers[path] = buf
        buf.copy_(src)
        return buf


class PrefetchIterator:
    """Wraps a host batch iterator; keeps ``depth`` batches in flight on
    ``device`` (default: the card; raises without one).  The pull order is
    the reference's: the buffer is filled before and after each hand-over.

    On a CUDA device each array of a batch is staged into pinned memory and
    copied with ``non_blocking=True`` on a side stream; a staging buffer is
    refilled only after the event of its last copy has fired.  The batch is
    handed over after the consumer's current stream waits on that event,
    and every tensor made on the side stream is marked as used by the
    consumer's stream (``record_stream``), so that the caching allocator
    does not reuse it while the consumer works.  On the CPU it is a plain
    iterator (``transform`` still applies)."""

    def __init__(self, it: Iterable, device=None, depth: int = 2,
                 transform: Callable | None = None):
        self._device = resolve(device)
        self._it: Iterator = iter(it)
        self._depth = max(1, depth)
        self._transform = transform
        self._buf: collections.deque = collections.deque()
        self._exhausted = False
        self._cuda = backend_supports_memory_kinds(self._device)
        if self._cuda:
            self._stream = torch.cuda.Stream(self._device)
            self._slots = [_Slot() for _ in range(self._depth + 1)]
            self._next_slot = 0

    def _to_device(self, batch):
        slot = self._slots[self._next_slot]
        self._next_slot = (self._next_slot + 1) % len(self._slots)
        if slot.event is not None:
            slot.event.synchronize()  # its buffers' last copy has ended
        made = []

        def stage(path, leaf):
            src = _host_tensor(leaf)
            if src is None:
                return leaf
            if src.is_cuda:  # already on a card: not a transfer to prefetch
                return src.to(self._device)
            out = slot.stage(path, src).to(self._device, non_blocking=True)
            made.append(out)
            return out

        with torch.cuda.stream(self._stream):
            batch = _map(stage, batch)
            slot.event = torch.cuda.Event()
            slot.event.record(self._stream)
        return batch, made, slot.event

    def _fill(self) -> None:
        while len(self._buf) < self._depth and not self._exhausted:
            try:
                batch = next(self._it)
            except StopIteration:
                self._exhausted = True
                return
            if self._transform is not None:
                batch = self._transform(batch)
            if self._cuda:
                self._buf.append(self._to_device(batch))
            else:
                self._buf.append((_map(_as_tensor, batch), (), None))

    def __iter__(self):
        return self

    def __next__(self):
        self._fill()
        if not self._buf:
            raise StopIteration
        out, made, event = self._buf.popleft()
        if event is not None:
            consumer = torch.cuda.current_stream(self._device)
            consumer.wait_event(event)
            for t in made:
                t.record_stream(consumer)
        self._fill()  # immediately dispatch the replacement transfer
        return out


def _as_tensor(_, leaf):
    t = _host_tensor(leaf)
    return leaf if t is None else t


def prefetch_to_device(tree, device=None):
    """One-shot bulk prefetch of a tree of tensors or arrays: issued on the
    current stream, not waited for (asynchronous from pinned memory).  On
    the CPU the arrays become tensors that share their memory."""
    dev = resolve(device)
    tree = _map(_as_tensor, tree)
    if not backend_supports_memory_kinds(dev):
        return tree
    return _map(lambda _, x: x.to(dev, non_blocking=True)
                if isinstance(x, torch.Tensor) else x, tree)
