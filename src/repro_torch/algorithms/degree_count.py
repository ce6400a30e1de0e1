"""Degree count — the paper's reference/calibration algorithm (§5.1).

Counts occurrences of vertex IDs in an edge list (as source or target) with
fetch-and-add atomics on a single counter array. Parameters vary almost
arbitrarily (counter array size, edge count), which is why the paper uses it
to train the contention model. Work is partitioned in non-overlapping parts
of 16k edges each — exactly the package grain reproduced here.

The PyTorch realization: per-package ``index_add_`` into the counter array
(the CUDA kernel in repro_torch.kernels.degree_count computes the identical
histogram with integer atomics).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from ..core import tracing
from ..core.descriptors import DEGREE_COUNT
from ..graph.structure import Graph, GraphStats

PACKAGE_EDGES = 16 * 1024  # §5.1: non-overlapping parts of 16k edges


def degree_count_reference(src: np.ndarray, dst: np.ndarray, num_counters: int) -> np.ndarray:
    counts = np.bincount(np.asarray(src) % num_counters, minlength=num_counters)
    counts += np.bincount(np.asarray(dst) % num_counters, minlength=num_counters)
    return counts.astype(np.int32)


def _count_range(src, dst, counters, lo: int, hi: int, *, num_counters: int) -> int:
    """Count edge endpoints for edges [lo, hi) into ``counters`` (in place);
    returns the number of edges counted."""
    for ids in (src[lo:hi], dst[lo:hi]):
        counters.index_add_(
            0, (ids % num_counters).to(torch.int64), torch.ones_like(ids)
        )
    return int(src[lo:hi].shape[0])


@dataclasses.dataclass
class DegreeCountExecutor:
    """QueryExecutor for degree count: one logical iteration over all edges,
    packaged at the 16k-edge grain."""

    graph: Graph
    num_counters: int | None = None
    desc: Any = DEGREE_COUNT

    # kernel-lowering opt-in for core.backends.CudaBackend (the JAX package
    # names it ``pallas_lowering``): the histogram kernel computes the
    # identical per-range endpoint counts
    kernel_lowering = "degree_count"

    def __post_init__(self):
        self._src = self.graph.src.to(torch.int32)
        self._dst = self.graph.dst.to(torch.int32)
        self._n = self.graph.num_edges
        self.num_counters = int(self.num_counters or self.graph.num_vertices)

    def graph_stats(self) -> GraphStats:
        return self.graph.stats

    def start(self) -> None:
        self._counters = torch.zeros(
            (self.num_counters,), dtype=torch.int32, device=self._src.device
        )
        self._edges = 0.0
        self._covered = 0
        self._done = False

    def finished(self) -> bool:
        return self._done

    def frontier(self) -> tuple[int, np.ndarray | None, float]:
        # "frontier" = the edge list itself; degree 1 per item (one update
        # pair per edge). Report edge count as the item count.
        return self._n, np.ones(min(self._n, 4096), dtype=np.int64), 0.0

    def run_packages(self, package_ids, packages, t: int, parallel: bool) -> None:
        from .common import merge_ranges

        # package bounds are in frontier (=edge) slots already
        for lo, hi in merge_ranges(packages.bounds, package_ids):
            edges = _count_range(
                self._src, self._dst, self._counters, lo, hi,
                num_counters=self.num_counters,
            )
            self._edges += float(edges)
            self._covered += hi - lo
        if self._covered >= self._n:
            self._done = True

    def edges_traversed(self) -> float:
        return self._edges

    def result(self) -> np.ndarray:
        return tracing.host_read(self._counters).numpy()

    # -- execution-backend hooks (core.backends.CudaBackend) -------------
    def edge_endpoints(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(src, dst) in edge order on the executor's device (the
        histogram input)."""
        return self._src, self._dst

    def apply_counts(self, counts: torch.Tensor, lo: int, hi: int) -> None:
        """Fold a backend-computed endpoint histogram (a tensor on the
        executor's device) for edges [lo, hi) into the counter array —
        identical bookkeeping to ``run_packages`` on that edge range."""
        self._counters += counts
        self._edges += float(hi - lo)
        self._covered += hi - lo
        if self._covered >= self._n:
            self._done = True
