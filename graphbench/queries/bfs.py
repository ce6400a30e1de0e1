"""Breadth-first search, top-down, from Graph500's search keys.

The keys: ``keys`` distinct vertices of out-degree at least
``min_out_degree``, drawn from the seed; the harness hands them to the
sessions in turn. The reference is a level-synchronous BFS
over the benchmark's own out-CSR; the answer is each vertex's level (-1
where unreached), compared exactly.

The control breaks the level guarantee the way a sweep that folds its
findings back in too early would: each level's frontier is expanded in two
halves, and what the first half finds joins the second half's sweep at the
same level.
"""
from __future__ import annotations

import numpy as np
import torch

from graphbench.reference import GraphRef, GraphSizes

CHECKS = {"bfs_level_mismatches": {"limit": 0, "combine": "sum"}}


def instances(query: dict, edges, seed: int):
    src, dst, v = edges
    out_deg = np.bincount(src, minlength=v)
    cand = np.flatnonzero(out_deg >= int(query["roots"]["min_out_degree"]))
    n_keys = int(query["roots"]["keys"])
    keys = np.random.default_rng([seed, 0x42F5]).choice(cand, size=n_keys, replace=False)
    return [("bfs", int(k)) for k in keys]


def make(port, graph, inst, stamped):
    return stamped(port.algorithms.BFSExecutor)(graph, inst[1])


def answer(executor) -> torch.Tensor:
    return executor._level


def _expand(ref: GraphRef, frontier: torch.Tensor, level: torch.Tensor) -> torch.Tensor:
    """The distinct unvisited out-neighbours of ``frontier``."""
    nb = ref.neighbours(frontier)
    return torch.unique(nb[level[nb] < 0])


def levels(ref: GraphRef, root: int, merge_early: bool = False) -> torch.Tensor:
    level = torch.full((ref.num_vertices,), -1, dtype=torch.int32, device=ref.src.device)
    level[root] = 0
    frontier = torch.tensor([root], dtype=torch.int64, device=level.device)
    depth = 0
    while frontier.numel():
        depth += 1
        if merge_early:  # the control
            half = frontier.numel() // 2
            first = _expand(ref, frontier[:half], level)
            level[first] = depth
            rest = _expand(ref, torch.cat([frontier[half:], first]), level)
            level[rest] = depth
            frontier = torch.cat([first, rest])
        else:
            frontier = _expand(ref, frontier, level)
            level[frontier] = depth
    return level


def expected(ref: GraphRef, inst) -> torch.Tensor:
    return levels(ref, inst[1])


def control(ref: GraphRef, inst) -> torch.Tensor:
    return levels(ref, inst[1], merge_early=True)


def compare(got: torch.Tensor, want: torch.Tensor) -> dict[str, float]:
    return {"bfs_level_mismatches": float((got.to(want.device, torch.int32) != want).sum())}


def work_edges(g: GraphSizes, inst, want) -> float:
    """The out-edges of every vertex the search reaches."""
    return float(g.out_deg[want >= 0].sum())


def needed_bytes(g: GraphSizes, items) -> dict[str, float]:
    """Bytes one round's searches need, each read once and each written
    once: the out-edges (int32 targets) and offsets of every vertex any of
    them reaches, once for the round (a multi-source sweep may serve them
    all), and each search's levels written."""
    reached = torch.zeros(g.num_vertices, dtype=torch.bool)
    for _, want in items:
        reached |= want >= 0
    shared = 4 * float(g.out_deg[reached].sum()) + 4 * float(reached.sum()) + 4
    return {"spmv": shared + 4.0 * g.num_vertices * len(items)}
