"""What a run may not hold: JAX, or the JAX package the port was made
from.  Modules are compared by their top-level name (the part before the
first dot), whole: ``repro_torch`` is the port, ``repro`` is not."""
from __future__ import annotations

import sys

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden(modules=None) -> list[str]:
    """The forbidden top-level names among ``modules`` (default: the
    process's ``sys.modules``)."""
    names = sys.modules if modules is None else modules
    return sorted({top_level(n) for n in names} & FORBIDDEN)
