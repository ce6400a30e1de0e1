"""Breadth-first search, top-down (the paper's data-driven algorithm).

Descriptor audit (repro_torch.core.descriptors.BFS_TOP_DOWN): per frontier
vertex we read its CSR range (2 mem) and do loop bookkeeping (2 ops); per edge
we load the neighbour id and its visited flag (2 mem) + 1 compare; per found
vertex a CAS on the visited word (1 atomic) + 1 write of parent/queue slot.

Execution: one edge-centric program on the graph's device; package slot
ranges select frontier slots. The CAS becomes an index write of ``True``
into the touched mask — every writer stores the same value, so concurrent
writes to one target need no atomics.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..core import tracing
from ..core.descriptors import BFS_TOP_DOWN
from ..graph.structure import Graph, GraphStats
from .common import EdgeArrays, compact_frontier, member_mask_from_slots, merge_ranges

NOT_VISITED = -1


# ---------------------------------------------------------------------------
# Pure reference (oracle for tests): plain numpy level-synchronous BFS.
# ---------------------------------------------------------------------------

def bfs_reference(graph: Graph, source: int, max_iters: int | None = None) -> np.ndarray:
    """Level array via level-synchronous BFS over the out-CSR (oracle; no
    scheduling). Each level gathers the out-edges of the frontier's
    vertices alone and keeps one copy of each newly reached vertex without
    a sort, so a level costs its frontier's edges, not ``|E|``: a road
    graph's thousands of levels and a power-law graph's huge middle levels
    both stay cheap at full size."""
    v = graph.num_vertices
    indptr = graph.csr.indptr.cpu().numpy().astype(np.int64)
    indices = graph.csr.indices.cpu().numpy()
    level = np.full(v, -1, dtype=np.int32)
    level[source] = 0
    owner = np.empty(v, dtype=np.int64)  # scratch: one slot per vertex
    frontier = np.array([source], dtype=np.int64)
    depth = 0
    limit = max_iters or v
    while frontier.size and depth < limit:
        depth += 1
        starts = indptr[frontier]
        counts = indptr[frontier + 1] - starts
        # every out-edge of the frontier: row start + offset within the row
        ends = np.cumsum(counts)
        edge = np.repeat(starts - (ends - counts), counts) + np.arange(ends[-1])
        reached = indices[edge]
        reached = reached[level[reached] < 0].astype(np.int64)
        # one position per distinct vertex survives: the one its slot names
        pos = np.arange(reached.size)
        owner[reached] = pos
        frontier = reached[owner[reached] == pos]
        level[frontier] = depth
    return level


# ---------------------------------------------------------------------------
# Iteration kernels
# ---------------------------------------------------------------------------

def _mark_targets(dst: torch.Tensor, active: torch.Tensor, num_vertices: int) -> torch.Tensor:
    """[V] bool: targets of the active edges. Inactive edges write to a
    discarded pad slot, so the write needs no host sync."""
    idx = torch.where(active, dst.to(torch.int64), num_vertices)
    touched = torch.zeros(num_vertices + 1, dtype=torch.bool, device=dst.device)
    touched[idx] = True
    return touched[:num_vertices]


def _expand_range(
    src: torch.Tensor,
    dst: torch.Tensor,
    visited: torch.Tensor,        # [V] bool
    next_mask: torch.Tensor,      # [V] bool accumulator
    frontier_list: torch.Tensor,  # [V] int32 padded
    n_frontier: int,
    lo: int,
    hi: int,
    *,
    num_vertices: int,
):
    """Expand the frontier slots [lo, hi): mark unvisited out-neighbours."""
    member = member_mask_from_slots(frontier_list, n_frontier, lo, hi, num_vertices)
    active = member[src.to(torch.int64)]                  # [E]
    touched = _mark_targets(dst, active, num_vertices)
    found = touched & ~visited
    edges = active.sum(dtype=torch.int32)
    return next_mask | found, edges


def _commit(visited, next_mask, level, depth: int, *, num_vertices: int):
    level = torch.where(next_mask, depth, level)
    visited = visited | next_mask
    frontier_list, n_frontier = compact_frontier(next_mask)
    return visited, level, frontier_list, n_frontier


# ---------------------------------------------------------------------------
# Executor (QueryExecutor protocol)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BFSExecutor:
    graph: Graph
    source: int
    desc: Any = BFS_TOP_DOWN
    max_iters: int | None = None

    # kernel-lowering opt-in for core.backends.CudaBackend (the JAX package
    # names it ``pallas_lowering``): frontier expansion is an SpMV over the
    # boolean semiring (count frontier parents per target, threshold at > 0)
    kernel_lowering = "bfs"

    def __post_init__(self):
        self._ea = EdgeArrays.from_graph(self.graph)
        self._out_deg_host = self.graph.out_deg_host

    # -- protocol ------------------------------------------------------
    def graph_stats(self) -> GraphStats:
        return self.graph.stats

    def start(self) -> None:
        v = self._ea.num_vertices
        dev = self._ea.src.device
        self._visited = torch.zeros((v,), dtype=torch.bool, device=dev)
        self._visited[self.source] = True
        self._level = torch.full((v,), NOT_VISITED, dtype=torch.int32, device=dev)
        self._level[self.source] = 0
        self._next = torch.zeros((v,), dtype=torch.bool, device=dev)
        self._frontier_list = torch.full((v,), v, dtype=torch.int32, device=dev)
        self._frontier_list[0] = self.source
        # the frontier size lives on the host: it is read at every package
        # boundary, and _commit's one sync per iteration refreshes it
        self._n_frontier = 1
        self._depth = 1
        self._edges = 0.0
        self._covered = 0
        # set once a backend has folded in the whole level's expansion
        # (apply_expansion); the level's other slot ranges only account
        self._level_expanded = False
        self._frontier_host: np.ndarray | None = np.array([self.source], dtype=np.int32)
        self._done = False

    def finished(self) -> bool:
        return self._done or (
            self.max_iters is not None and self._depth > self.max_iters
        )

    def frontier(self) -> tuple[int, np.ndarray | None, float]:
        fl = self.frontier_vertices()
        degrees = self._out_deg_host[fl] if fl.size else np.zeros(0, np.int64)
        unvisited = self.graph.stats.v_reach - tracing.host_read(self._visited.sum(), float)
        return int(fl.size), degrees, max(unvisited, 0.0)

    def frontier_vertices(self) -> np.ndarray:
        """Compacted-frontier vertex ids — the locality-placement signal: a
        multi-domain engine bins these (degree-weighted) into graph shards
        to pick the domain this iteration's mass touches most."""
        if self._frontier_host is None:
            n = self._n_frontier
            self._frontier_host = tracing.host_read(self._frontier_list[:n]).numpy()
        return self._frontier_host

    def run_packages(self, package_ids, packages, t: int, parallel: bool) -> None:
        """Expand the given packages (slot ranges of the compacted frontier).

        ``t``/``parallel`` select the modelled execution mode; on one device
        both modes run the same edge-centric program (the distinction drives
        the cost model)."""
        ranges = merge_ranges(packages.bounds, package_ids)
        for lo, hi in ranges:
            self._next, edges = _expand_range(
                self._ea.src,
                self._ea.dst,
                self._visited,
                self._next,
                self._frontier_list,
                self._n_frontier,
                lo,
                hi,
                num_vertices=self._ea.num_vertices,
            )
            self._edges += tracing.host_read(edges, float)
            self._covered += hi - lo
        # the scheduler hands each package exactly once per iteration; once
        # the slot ranges cover the whole frontier, the iteration commits
        if self._covered >= self._n_frontier:
            self.end_iteration()

    def end_iteration(self) -> None:
        (
            self._visited,
            self._level,
            self._frontier_list,
            n_frontier,
        ) = _commit(
            self._visited,
            self._next,
            self._level,
            self._depth,
            num_vertices=self._ea.num_vertices,
        )
        self._n_frontier = tracing.host_read(n_frontier, int)
        self._next = torch.zeros_like(self._next)
        self._depth += 1
        self._covered = 0
        self._level_expanded = False
        self._frontier_host = None
        if self._n_frontier == 0:
            self._done = True

    def edges_traversed(self) -> float:
        return self._edges

    def result(self) -> np.ndarray:
        return tracing.host_read(self._level).numpy()

    # -- execution-backend hooks (core.backends.CudaBackend) -------------
    def out_edges(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(src, dst) in out-edge order on the executor's device (the SpMV
        edge list)."""
        return self._ea.src, self._ea.dst

    def frontier_slot_vertices(self, lo: int, hi: int) -> torch.Tensor:
        """Vertex ids occupying compacted-frontier slots [lo, hi), as an
        int32 tensor on the executor's device."""
        return self._frontier_list[lo : min(hi, self._n_frontier)]

    def level_expanded(self) -> bool:
        """Whether this level's next frontier is already folded in: the
        level's remaining slot ranges need no expansion of their own."""
        return self._level_expanded

    def apply_expansion(self, counts: torch.Tensor, lo: int, hi: int) -> None:
        """Fold a backend-computed parent count [V] of the *whole* current
        frontier into the next-frontier mask (``counts > 0`` is the level's
        touched set), then account for frontier slots [lo, hi) as
        :meth:`account_range` does. Called once a level; the level's other
        ranges go to :meth:`account_range` alone."""
        self._next = self._next | ((counts > 0) & ~self._visited)
        self._level_expanded = True
        self.account_range(lo, hi)

    def account_range(self, lo: int, hi: int) -> None:
        """The bookkeeping ``run_packages`` does for frontier slots [lo,
        hi) (edges = out-degrees of the range's members), committing the
        level once the ranges cover the whole frontier."""
        members = self.frontier_vertices()[lo:hi]
        if members.size:
            self._edges += float(self._out_deg_host[members].sum())
        self._covered += hi - lo
        if self._covered >= self._n_frontier:
            self.end_iteration()


# ---------------------------------------------------------------------------
# Direction-optimized BFS (beyond-paper: Beamer et al. [3], driven by the
# paper's own estimators)
# ---------------------------------------------------------------------------

def _expand_bottom_up(
    in_src: torch.Tensor,   # [E] in-edge sources (per in-CSR order)
    in_dst: torch.Tensor,   # [E] in-edge targets
    visited: torch.Tensor,
    frontier_mask: torch.Tensor,
    *,
    num_vertices: int,
):
    """Bottom-up step: every unvisited vertex scans its in-edges for a
    frontier parent — cheaper than top-down when the frontier is a large
    fraction of |V_reach| (each unvisited vertex stops at one hit; here,
    edge-vectorized: an in-edge contributes iff its source is in the
    frontier and its target unvisited)."""
    unvisited_dst = ~visited[in_dst.to(torch.int64)]
    contributes = frontier_mask[in_src.to(torch.int64)] & unvisited_dst
    found = _mark_targets(in_dst, contributes, num_vertices)
    edges = unvisited_dst.sum(dtype=torch.int32)  # in-edges scanned
    return found, edges


@dataclasses.dataclass
class DirectionOptimizedBFSExecutor(BFSExecutor):
    """BFS that switches top-down ↔ bottom-up per iteration using the
    §3.1 estimators: when the predicted touched set |U_j| exceeds
    ``switch_fraction``·|V_reach|, the bottom-up direction wins (fewer
    edge inspections). The estimator replaces Beamer's measured-frontier
    heuristic — preparation stays ahead of execution, as in the paper."""

    switch_fraction: float = 0.25
    # the direction switch lives inside run_packages; a kernel lowering that
    # bypasses it would silently disable bottom-up — opt out
    kernel_lowering = None

    def run_packages(self, package_ids, packages, t: int, parallel: bool) -> None:
        from ..core.estimators import TraversalEstimator

        est = TraversalEstimator(
            deg_mean=self.graph.stats.deg_out_mean,
            deg_max=self.graph.stats.deg_out_max,
            v_reach=self.graph.stats.v_reach,
        )
        fsize = self._n_frontier
        touched = est.touched(fsize)
        if touched > self.switch_fraction * self.graph.stats.v_reach:
            # bottom-up consumes the whole frontier in one pass; package
            # ranges are irrelevant (every unvisited vertex is a work item)
            frontier_mask = member_mask_from_slots(
                self._frontier_list, fsize, 0, fsize, self._ea.num_vertices
            )
            found, edges = _expand_bottom_up(
                self._ea.in_src,
                self._ea.in_dst,
                self._visited,
                frontier_mask,
                num_vertices=self._ea.num_vertices,
            )
            self._next = self._next | found
            self._edges += tracing.host_read(edges, float)
            self._covered = self._n_frontier
            self.end_iteration()
        else:
            super().run_packages(package_ids, packages, t, parallel)


def bfs_with_engine(graph: Graph, source: int, engine) -> np.ndarray:
    """Run one BFS query through a MultiQueryEngine-compatible loop."""
    ex = BFSExecutor(graph, source)
    from ..core.session import QueryRecord

    rec = QueryRecord(session=0, query=0, algorithm=ex.desc.name)
    engine.run_query(ex, rec)
    return ex.result()
