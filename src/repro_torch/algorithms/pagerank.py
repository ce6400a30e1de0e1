"""PageRank, push and pull variants (the paper's topology-centric algorithm).

Descriptor audit (repro_torch.core.descriptors):
  PR_PUSH — per vertex: load rank, divide by out-degree (≈4 ops incl. div),
  store contribution (2 mem); per edge: one atomic add of the contribution
  into the *target* accumulator (scatter — contended). Realized as an
  unsorted ``index_add_`` over the target ids.

  PR_PULL — per vertex: damping multiply-add + store (4 ops, 2 mem); per
  edge: gather the *source* contribution + add (1 op, 1 mem, NO atomics: each
  target is owned by exactly one consumer — a segment sum over the in-edge
  list, which is sorted by target).

Both variants share preparation: topology-centric → prepare once (§4.5).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..core import tracing
from ..core.descriptors import PR_PULL, PR_PUSH
from ..graph.structure import Graph, GraphStats
from .common import EdgeArrays, merge_ranges

DAMPING = 0.85


# ---------------------------------------------------------------------------
# Pure references (oracles)
# ---------------------------------------------------------------------------

def pagerank_reference(
    graph: Graph, *, damping: float = DAMPING, iters: int = 20
) -> np.ndarray:
    """Dense power iteration oracle (handles dangling mass like our kernels:
    dangling rank redistributes uniformly)."""
    v = graph.num_vertices
    out_deg = graph.out_degrees().cpu().numpy().astype(np.float64)
    src = graph.src.cpu().numpy()
    dst = graph.dst.cpu().numpy()
    rank = np.full(v, 1.0 / v)
    for _ in range(iters):
        contrib = np.where(out_deg > 0, rank / np.maximum(out_deg, 1), 0.0)
        acc = np.bincount(dst, weights=contrib[src], minlength=v)
        dangling = rank[out_deg == 0].sum()
        rank = (1 - damping) / v + damping * (acc + dangling / v)
    return rank


# ---------------------------------------------------------------------------
# Iteration kernels (range-parameterized; [lo, hi) is a vertex range)
# ---------------------------------------------------------------------------

def _pull_range(in_src, in_dst, contrib, acc, lo: int, hi: int, *, num_vertices: int):
    """Pull partial update: targets in [lo, hi) gather their in-edge mass.

    in-edge list is sorted by target → contiguous segments, no conflicts."""
    sel = (in_dst >= lo) & (in_dst < hi)
    vals = torch.where(sel, contrib[in_src.to(torch.int64)], 0.0)
    acc = acc.index_add(0, in_dst.to(torch.int64), vals)
    edges = sel.sum(dtype=torch.int32)
    return acc, edges


def _push_range(src, dst, contrib, acc, lo: int, hi: int, *, num_vertices: int):
    """Push partial update: sources in [lo, hi) scatter into their targets
    (the atomic-add analogue — unsorted scatter-add)."""
    sel = (src >= lo) & (src < hi)
    vals = torch.where(sel, contrib[src.to(torch.int64)], 0.0)
    acc = acc.index_add(0, dst.to(torch.int64), vals)
    edges = sel.sum(dtype=torch.int32)
    return acc, edges


def _prepare_contrib(rank, out_deg):
    safe = torch.clamp(out_deg, min=1)
    contrib = torch.where(out_deg > 0, rank / safe, 0.0)
    dangling = torch.where(out_deg == 0, rank, 0.0).sum()
    return contrib, dangling


def _finish_iteration(acc, dangling, damping, *, num_vertices: int):
    base = (1.0 - damping) / num_vertices
    new_rank = base + damping * (acc + dangling / num_vertices)
    return new_rank


# ---------------------------------------------------------------------------
# Executor
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PageRankExecutor:
    graph: Graph
    mode: str = "pull"  # "pull" | "push"
    damping: float = DAMPING
    max_iters: int = 20
    tol: float = 1e-6
    desc: Any = None

    def __post_init__(self):
        if self.mode not in ("pull", "push"):
            raise ValueError(self.mode)
        self.desc = PR_PULL if self.mode == "pull" else PR_PUSH
        self._ea = EdgeArrays.from_graph(self.graph)
        self._deg_host = (
            self.graph.in_deg_host if self.mode == "pull" else self.graph.out_deg_host
        )
        # kernel-lowering opt-in for core.backends.CudaBackend (the JAX
        # package names it ``pallas_lowering``): pull is an owner-computes
        # SpMV; push's unsorted scatter has no kernel lowering
        self.kernel_lowering = "pr_pull" if self.mode == "pull" else None

    def graph_stats(self) -> GraphStats:
        return self.graph.stats

    def start(self) -> None:
        v = self._ea.num_vertices
        dev = self._ea.src.device
        self._rank = torch.full((v,), 1.0 / v, dtype=torch.float32, device=dev)
        self._acc = torch.zeros((v,), dtype=torch.float32, device=dev)
        self._contrib, self._dangling = _prepare_contrib(
            self._rank, self._ea.out_deg
        )
        self._iter = 0
        self._edges = 0.0
        self._covered = 0
        self._converged = False

    def finished(self) -> bool:
        return self._converged or self._iter >= self.max_iters

    def frontier(self) -> tuple[int, np.ndarray | None, float]:
        # topology-centric: every vertex is processed every iteration
        return self._ea.num_vertices, self._deg_host, 0.0

    def run_packages(self, package_ids, packages, t: int, parallel: bool) -> None:
        ranges = merge_ranges(packages.bounds, package_ids)
        fn = _pull_range if self.mode == "pull" else _push_range
        e1, e2 = (
            (self._ea.in_src, self._ea.in_dst)
            if self.mode == "pull"
            else (self._ea.src, self._ea.dst)
        )
        for lo, hi in ranges:
            self._acc, edges = fn(
                e1, e2, self._contrib, self._acc, lo, hi,
                num_vertices=self._ea.num_vertices,
            )
            self._edges += tracing.host_read(edges, float)
            self._covered += hi - lo
        if self._covered >= self._ea.num_vertices:
            self._end_iteration()

    def _end_iteration(self) -> None:
        new_rank = _finish_iteration(
            self._acc, self._dangling, self.damping,
            num_vertices=self._ea.num_vertices,
        )
        delta = tracing.host_read((new_rank - self._rank).abs().sum(), float)
        self._rank = new_rank
        self._acc = torch.zeros_like(self._acc)
        self._contrib, self._dangling = _prepare_contrib(
            self._rank, self._ea.out_deg
        )
        self._iter += 1
        self._covered = 0
        if delta < self.tol:
            self._converged = True

    def edges_traversed(self) -> float:
        return self._edges

    def result(self) -> np.ndarray:
        return tracing.host_read(self._rank).numpy()

    # -- execution-backend hooks (core.backends.CudaBackend, pull mode) --
    @property
    def contrib(self) -> torch.Tensor:
        """Current per-source contribution vector (the SpMV input)."""
        return self._contrib

    def pull_edges(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(in_src, in_dst) in in-edge (sorted-by-target) order, on the
        executor's device."""
        return self._ea.in_src, self._ea.in_dst

    def apply_pull_aggregate(self, agg: torch.Tensor, lo: int, hi: int, edges: float) -> None:
        """Fold a backend-computed pull partial for targets [lo, hi) into the
        accumulator — identical bookkeeping to ``run_packages`` on that range
        (coverage tracking, edge count, end-of-iteration commit).

        ``agg`` is indexed by target (``[V]`` or longer), but only its lanes
        ``[lo, hi)`` are defined: the rest may hold another range's sums.
        They are added into the accumulator's own lanes in place; no other
        lane is touched."""
        self._acc[lo:hi].add_(agg[lo:hi])
        self._edges += float(edges)
        self._covered += hi - lo
        if self._covered >= self._ea.num_vertices:
            self._end_iteration()
