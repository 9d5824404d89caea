"""Graph500 — BFS kernel (paper Table I).

Data-dependent access: each level sweeps a frontier-dependent slice of the
edge list (modeled with the simulator's ``partial`` access + rotating
cursor).  Advise: PREFERRED_LOCATION(DEVICE) on the adjacency (the paper
keeps data used by the GPU close to GPU memory); READ_MOSTLY on row
pointers.  Figure of merit: mean BFS iteration (paper §III-B).
``workload()`` builds the trace; variant lowering lives in
``umbench.variants``.

``numeric()`` computes it for real in plain PyTorch, as the JAX side
computes it in plain ``jnp``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.advise import MemorySpace
from repro_torch.device import resolve
from repro_torch.umbench.workload import Workload, WorkloadBuilder

NAME = "graph500"
LEVELS = 8


def workload(total_bytes: float, iters: int = LEVELS) -> Workload:
    col = int(total_bytes * 0.70)
    row = int(total_bytes * 0.10)
    state = int(total_bytes * 0.20) // 3
    w = WorkloadBuilder(NAME)
    w.alloc("col_idx", col, role="graph")
    w.alloc("row_ptr", row, role="graph")
    for nm in ("frontier", "visited", "parent"):
        w.alloc(nm, state, role="state")
    w.host_write("col_idx")
    w.host_write("row_ptr")
    w.host_write("frontier", state)

    w.advise_preferred_location("col_idx", MemorySpace.DEVICE)
    w.advise_read_mostly("row_ptr")
    w.prefetch("col_idx", "row_ptr")

    edges = col / 8  # long indices (paper: long data types)
    for _ in range(iters):
        w.kernel(
            "bfs_level",
            flops=4.0 * edges / iters,
            reads=("col_idx", "row_ptr", "frontier", "visited"),
            writes=("frontier", "visited", "parent"),
            partial={"col_idx": 1.0 / iters},
        )
    w.readback("parent")
    return w.build()


def random_graph(n: int, avg_deg: int, seed: int = 0):
    """Undirected random graph in CSR: (row_ptr, col_idx, sorted edges, max
    degree).  Seed 0 gives the JAX app's graph."""
    rng = np.random.default_rng(seed)
    edges = set()
    for _ in range(n * avg_deg):
        u, v = rng.integers(0, n, 2)
        if u != v:
            edges.add((int(min(u, v)), int(max(u, v))))
    adj = [[] for _ in range(n)]
    for u, v in edges:
        adj[u].append(v)
        adj[v].append(u)
    ptr, idx = [0], []
    for i in range(n):
        idx += sorted(adj[i])
        ptr.append(len(idx))
    max_deg = max(1, max(len(a) for a in adj))
    return ptr, idx, sorted(edges), max_deg


def bfs_levels(row_ptr, col_idx, src: int, n: int, max_deg: int, device=None):
    """Dense-frontier BFS returning each node's level (-1 if unreachable).

    Row i's neighbours are gathered into a (n, max_deg) table padded with
    -1.  Once a level adds no node the levels cannot change, so the loop
    stops there instead of running all n levels.
    """
    dev = resolve(device)
    pad = np.full((n, max_deg), -1, np.int64)
    for i in range(n):
        pad[i, :row_ptr[i + 1] - row_ptr[i]] = col_idx[row_ptr[i]:row_ptr[i + 1]]
    nbr = torch.from_numpy(pad).to(dev)
    valid = nbr >= 0
    targets = torch.where(valid, nbr, 0).reshape(-1)

    level = torch.full((n,), -1, dtype=torch.int32, device=dev)
    level[src] = 0
    frontier = torch.zeros(n, dtype=torch.bool, device=dev)
    frontier[src] = True
    for d in range(n):
        hits = (frontier[:, None] & valid).reshape(-1).to(torch.uint8)
        reached = torch.zeros(n, dtype=torch.uint8, device=dev).scatter_reduce_(
            0, targets, hits, reduce="amax")
        frontier = reached.bool() & (level < 0)
        if not frontier.any():
            break
        level = torch.where(frontier, d + 1, level)
    return level


def numeric(seed: int = 0, n: int = 64, avg_deg: int = 4, device=None):
    """BFS levels from node 0 of a random graph, for comparison against
    networkx."""
    dev = resolve(device)
    ptr, idx, edges, max_deg = random_graph(n, avg_deg, seed)
    return {"level": bfs_levels(ptr, idx, 0, n, max_deg, dev),
            "edges": edges, "n": n}
