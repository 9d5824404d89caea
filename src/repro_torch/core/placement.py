"""Placement: turn MemorySpace decisions into tensor locations.

The counterpart of ``repro.core.placement``.  On the port,
``MemorySpace.DEVICE`` is the CUDA card's memory and ``MemorySpace.HOST`` is
page-locked (pinned) host memory, which the card's copy engines read and
write asynchronously at the link's full rate.  Where the caller runs on the
CPU there is one memory: as JAX does on a backend without memory kinds, the
transfers are identities there and the plan is carried analytically.  On a
machine with a card the probe must pass; a failed pinned allocation or copy
raises, and nothing carries on on the CPU.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from repro_torch.core.advise import MemorySpace
from repro_torch.device import resolve


def _default_device(device) -> torch.device:
    """``None`` is the card when there is one, else the CPU (the reference's
    ``jax.default_backend()``); anything else is taken as given."""
    if device is None:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    return torch.device(device)


@functools.lru_cache(maxsize=None)
def _probe(device: torch.device) -> bool:
    x = torch.arange(8, dtype=torch.float32).pin_memory()
    if not x.is_pinned():
        raise RuntimeError(f"placement probe on {device}: pinned host allocation failed")
    y = x.to(device, non_blocking=True) * 2.0
    back = torch.empty(8, dtype=torch.float32, pin_memory=True)
    back.copy_(y, non_blocking=True)
    torch.cuda.current_stream(device).synchronize()
    if not torch.equal(back, x * 2.0):
        raise RuntimeError(f"placement probe on {device}: a non_blocking round trip "
                           f"through pinned memory returned {back.tolist()}")
    return True


def backend_supports_memory_kinds(device=None) -> bool:
    """True if ``device`` (default: the card when there is one) has a host
    tier apart from its own memory: a CUDA device, once a pinned allocation
    and a ``non_blocking`` round trip through it have worked, which is
    checked once per device and raises if it fails.  False on the CPU."""
    dev = _default_device(device)
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"placement: no memory tiers on a {dev.type} device")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return _probe(dev)


@dataclasses.dataclass(frozen=True)
class Placement:
    """A partition spec plus the memory space it should live in.  ``spec``
    is kept as plain data (the reference's ``PartitionSpec`` entries) until
    the port has a device mesh."""

    spec: tuple = ()
    space: MemorySpace = MemorySpace.DEVICE


def host(spec: tuple = ()) -> Placement:
    return Placement(spec, MemorySpace.HOST)


def device(spec: tuple = ()) -> Placement:
    return Placement(spec, MemorySpace.DEVICE)


def to_device_space(x: torch.Tensor, device=None) -> torch.Tensor:
    """Host->device transfer (the UM 'migration') on the current stream:
    asynchronous from pinned memory.  ``device=None`` is the card and raises
    without one; on the CPU it is the identity."""
    dev = resolve(device)
    if not backend_supports_memory_kinds(dev):
        return x
    return x.to(dev, non_blocking=True)


def to_host_space(x: torch.Tensor, device=None) -> torch.Tensor:
    """Device->host transfer (offload / eviction) into pinned memory; waits
    for the copy, so the result can be read on the host at once.  On the
    CPU it is the identity."""
    dev = resolve(device)
    if not backend_supports_memory_kinds(dev):
        return x
    out = _pinned_copy(x)
    torch.cuda.current_stream(x.device if x.is_cuda else dev).synchronize()
    return out


def _pinned_copy(x: torch.Tensor) -> torch.Tensor:
    """A pinned host tensor that ``x`` is copied into on the current stream
    (not waited for)."""
    out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    out.copy_(x, non_blocking=True)
    return out
