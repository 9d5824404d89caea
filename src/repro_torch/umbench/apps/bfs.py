"""Graph500: BFS (paper Table I), computed for real in plain PyTorch, as the
JAX side computes it in plain ``jnp``."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve

NAME = "graph500"


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
