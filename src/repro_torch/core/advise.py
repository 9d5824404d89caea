"""Memory advises — the paper's §II-B, adapted to tensor roles.

The port's copy of ``repro.core.advise`` (which imports no JAX), so that a
policy built here compares equal to the reference's.

CUDA exposes three advises on managed allocations; we expose the same three
on *tensor roles* (a role is a stable name for a class of arrays in the
training/serving state: "params", "opt_state", "kv_cache", "activations",
"embedding", "router", ...).  The semantics map as described in DESIGN.md §2:

  READ_MOSTLY          -> replicate instead of reshard-per-use; a read-only
                          copy lives on every accessor (paper Fig. 2a).
  PREFERRED_LOCATION   -> pin the tensor's memory space (HOST or DEVICE) and
                          never migrate it wholesale (paper Fig. 2b).
  ACCESSED_BY          -> establish a streaming path from the non-resident
                          side instead of migrating (paper Fig. 2c).

An `AdvisePolicy` is a mapping role -> list[AdviseDirective]; the
ResidencyPlanner consumes it together with the measured working set to emit a
concrete ResidencyPlan.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Iterable, Mapping


class MemorySpace(enum.Enum):
    """Physical memory tiers visible to the runtime."""

    DEVICE = "device"          # the CUDA card's HBM
    HOST = "pinned_host"       # page-locked host DRAM, DMA-able by the card

    @property
    def xla_memory_kind(self) -> str:
        """The reference's name of the tier (its XLA memory kind)."""
        return self.value


class Advise(enum.Enum):
    """The three CUDA UM advises (paper §II-B)."""

    READ_MOSTLY = "read_mostly"
    PREFERRED_LOCATION = "preferred_location"
    ACCESSED_BY = "accessed_by"


class Accessor(enum.Enum):
    """Who accesses the region remotely (argument of ACCESSED_BY)."""

    HOST = "host"
    DEVICE = "device"


@dataclasses.dataclass(frozen=True)
class AdviseDirective:
    """One advise applied to one tensor role.

    ``location`` is meaningful for PREFERRED_LOCATION, ``accessor`` for
    ACCESSED_BY; READ_MOSTLY takes neither (mirrors the CUDA API where the
    device argument is ignored for cudaMemAdviseSetReadMostly).
    """

    advise: Advise
    location: MemorySpace | None = None
    accessor: Accessor | None = None

    def __post_init__(self):
        if self.advise is Advise.PREFERRED_LOCATION and self.location is None:
            raise ValueError("PREFERRED_LOCATION requires a location")
        if self.advise is Advise.ACCESSED_BY and self.accessor is None:
            raise ValueError("ACCESSED_BY requires an accessor")
        if self.advise is Advise.READ_MOSTLY and (
            self.location is not None or self.accessor is not None
        ):
            raise ValueError("READ_MOSTLY takes no location/accessor")


# Convenience constructors mirroring the CUDA API names -----------------------

def set_read_mostly() -> AdviseDirective:
    return AdviseDirective(Advise.READ_MOSTLY)


def set_preferred_location(space: MemorySpace) -> AdviseDirective:
    return AdviseDirective(Advise.PREFERRED_LOCATION, location=space)


def set_accessed_by(accessor: Accessor) -> AdviseDirective:
    return AdviseDirective(Advise.ACCESSED_BY, accessor=accessor)


@dataclasses.dataclass
class AdvisePolicy:
    """role -> directives.  Roles not present fall back to default UM behavior
    (DEVICE-preferred, migrate-on-demand)."""

    directives: dict[str, tuple[AdviseDirective, ...]] = dataclasses.field(
        default_factory=dict
    )

    def advise(self, role: str, *ds: AdviseDirective) -> "AdvisePolicy":
        cur = self.directives.get(role, ())
        self.directives[role] = cur + tuple(ds)
        return self

    def for_role(self, role: str) -> tuple[AdviseDirective, ...]:
        return self.directives.get(role, ())

    def is_read_mostly(self, role: str) -> bool:
        return any(d.advise is Advise.READ_MOSTLY for d in self.for_role(role))

    def preferred_location(self, role: str) -> MemorySpace | None:
        for d in self.for_role(role):
            if d.advise is Advise.PREFERRED_LOCATION:
                return d.location
        return None

    def accessed_by(self, role: str) -> tuple[Accessor, ...]:
        return tuple(
            d.accessor for d in self.for_role(role) if d.advise is Advise.ACCESSED_BY
        )

    @staticmethod
    def from_spec(spec: Mapping[str, Iterable[str]]) -> "AdvisePolicy":
        """Build from a config-file-friendly spec, e.g.
        ``{"opt_state": ["preferred_location:host", "accessed_by:device"],
           "embedding": ["read_mostly"]}``."""
        pol = AdvisePolicy()
        for role, items in spec.items():
            for item in items:
                kind, _, arg = item.partition(":")
                if kind == "read_mostly":
                    pol.advise(role, set_read_mostly())
                elif kind == "preferred_location":
                    space = MemorySpace.HOST if arg == "host" else MemorySpace.DEVICE
                    pol.advise(role, set_preferred_location(space))
                elif kind == "accessed_by":
                    acc = Accessor.HOST if arg == "host" else Accessor.DEVICE
                    pol.advise(role, set_accessed_by(acc))
                else:
                    raise ValueError(f"unknown advise spec item {item!r}")
        return pol


# The best-practice default policy the paper derives in §III-A.2: keep data
# used by the GPU close to GPU memory; host-initialized data gets ACCESSED_BY
# host; constants get READ_MOSTLY.
def paper_default_policy() -> AdvisePolicy:
    return (
        AdvisePolicy()
        .advise("params", set_preferred_location(MemorySpace.DEVICE))
        .advise("params", set_accessed_by(Accessor.HOST))
        .advise("embedding", set_read_mostly())
        .advise("constants", set_read_mostly())
        .advise("kv_cache", set_preferred_location(MemorySpace.DEVICE))
        .advise("activations", set_preferred_location(MemorySpace.DEVICE))
    )
