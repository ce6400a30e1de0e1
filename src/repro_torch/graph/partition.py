"""Partitioners: cost-based package boundaries and locality-domain shards.

Three consumers:
  * the scheduler's package generator (§4.2) — degree-prefix-sum packages;
  * the distributed runtime — edge/vertex range shards for shard_map;
  * the locality-domain runtime — :class:`GraphPartition` splits a graph
    into ``D`` contiguous degree-balanced vertex shards with per-shard CSR
    views and cut/halo statistics, and answers the placement question the
    engine asks every iteration: which domain does this frontier's degree
    mass touch most?
"""
from __future__ import annotations

import dataclasses

import numpy as np


def equal_ranges(n: int, parts: int) -> np.ndarray:
    """[parts+1] boundaries of an equal-count split of range(n)."""
    return np.linspace(0, n, parts + 1).round().astype(np.int64)


def degree_balanced_ranges(degrees: np.ndarray, parts: int) -> np.ndarray:
    """Split vertices into ``parts`` contiguous ranges of ~equal total degree.

    This is the work-package boundary computation of §4.2: iterate the
    frontier accumulating out-degree until the per-package work share is
    exceeded. Implemented as a prefix-sum + searchsorted (O(V)).

    The boundaries are monotone but *not* strictly increasing: a single
    vertex heavier than the per-range target swallows several targets and
    the ranges in between come out empty (duplicate bounds). Consumers that
    attribute work per range must mask zero-length ranges (see
    :func:`heavy_first_order`)."""
    degrees = np.asarray(degrees, dtype=np.int64)
    csum = np.concatenate([[0], np.cumsum(degrees)])
    total = csum[-1]
    if total == 0:
        return equal_ranges(len(degrees), parts)
    targets = np.linspace(0, total, parts + 1)
    bounds = np.searchsorted(csum, targets, side="left")
    bounds[0], bounds[-1] = 0, len(degrees)
    return np.maximum.accumulate(bounds).astype(np.int64)


def heavy_first_order(degrees: np.ndarray, bounds: np.ndarray) -> np.ndarray:
    """Package execution order, heaviest package first (§4.2: packages whose
    cost is dominated by a single heavy vertex run first).

    ``bounds`` may contain duplicates (a heavy vertex that exceeds the
    per-package target makes :func:`degree_balanced_ranges` emit empty
    ranges). ``np.add.reduceat`` on a repeated index returns the *element at
    that index* instead of 0, which would order an empty package as if it
    owned the heavy vertex's work — so zero-length ranges are masked to zero
    work explicitly."""
    degrees = np.asarray(degrees)
    if len(bounds) <= 1:
        return np.argsort(-np.array([degrees.sum()]), kind="stable")
    work = np.add.reduceat(
        np.concatenate([degrees, [0]]).astype(np.int64), bounds[:-1]
    )
    work[np.diff(bounds) == 0] = 0  # empty packages carry no work
    return np.argsort(-work, kind="stable")


def edge_shards(num_edges: int, num_shards: int) -> np.ndarray:
    """Edge-range boundaries for distributing a COO edge list over devices."""
    return equal_ranges(num_edges, num_shards)


def vertex_shards(num_vertices: int, num_shards: int) -> np.ndarray:
    return equal_ranges(num_vertices, num_shards)


# ---------------------------------------------------------------------------
# Locality-domain partitioning (GraphPartition)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GraphShard:
    """One contiguous vertex shard of a :class:`GraphPartition`.

    Carries a *shard-local CSR view*: ``indptr`` is rebased to the shard
    (``indptr[0] == 0``), ``indices`` holds the out-neighbour ids (global
    vertex ids — edges may leave the shard; that is what the cut statistics
    measure). The scheduler places and prices queries by shard; execution
    backends dispatch against the whole graph's tables."""

    index: int
    v_lo: int
    v_hi: int
    indptr: np.ndarray          # [num_vertices+1] rebased row offsets
    indices: np.ndarray         # out-neighbour ids (global)
    internal_edges: int         # edges whose target lies inside [v_lo, v_hi)
    cut_edges: int              # edges whose target lies outside the shard
    halo: int                   # distinct external vertices referenced

    @property
    def num_vertices(self) -> int:
        return self.v_hi - self.v_lo

    @property
    def num_edges(self) -> int:
        return int(self.indices.size)

    @property
    def cut_fraction(self) -> float:
        """Fraction of the shard's out-edges that cross the domain boundary
        (the remote-access exposure of a query placed on this shard)."""
        e = self.num_edges
        return self.cut_edges / e if e else 0.0


@dataclasses.dataclass(frozen=True)
class GraphPartition:
    """``D`` contiguous degree-balanced vertex shards of one graph.

    Boundaries come from :func:`degree_balanced_ranges` over the out-degree
    array, so every shard carries ~the same total degree mass — the same
    balance criterion the §4.2 work packages use, applied at machine scale.
    Duplicate/clamped bounds (a hub heavier than the per-shard target) are
    legal: the resulting shard is empty and simply never wins a placement.

    The placement primitive is :meth:`domain_mass`: given a frontier (vertex
    ids + optional per-vertex degrees, i.e. exactly the sampled statistics
    preparation already computes), return how much degree mass falls into
    each shard. ``dominant_domain`` is its argmax. ``vertices=None`` means a
    whole-graph frontier (topology-centric algorithms) and uses the static
    per-shard degree mass."""

    graph_key: tuple | None
    num_vertices: int
    bounds: np.ndarray          # [D+1] shard boundaries (monotone)
    shards: tuple[GraphShard, ...]
    degree_mass: np.ndarray     # [D] total out-degree per shard

    @classmethod
    def build(cls, graph, domains: int) -> "GraphPartition":
        """Partition ``graph`` into ``domains`` contiguous shards."""
        if domains < 1:
            raise ValueError("domains must be >= 1")
        indptr = np.asarray(graph.csr.indptr.cpu(), dtype=np.int64)
        indices = np.asarray(graph.csr.indices.cpu(), dtype=np.int64)
        degrees = np.diff(indptr)
        nv = int(indptr.shape[0]) - 1
        bounds = degree_balanced_ranges(degrees, domains)
        shards = []
        mass = np.zeros(domains, dtype=np.int64)
        for d in range(domains):
            v_lo, v_hi = int(bounds[d]), int(bounds[d + 1])
            e_lo, e_hi = int(indptr[v_lo]), int(indptr[v_hi])
            sub_indices = indices[e_lo:e_hi]
            internal = (sub_indices >= v_lo) & (sub_indices < v_hi)
            ext = sub_indices[~internal]
            shards.append(
                GraphShard(
                    index=d,
                    v_lo=v_lo,
                    v_hi=v_hi,
                    indptr=indptr[v_lo : v_hi + 1] - e_lo,
                    indices=sub_indices,
                    internal_edges=int(internal.sum()),
                    cut_edges=int(sub_indices.size - internal.sum()),
                    halo=int(np.unique(ext).size),
                )
            )
            mass[d] = e_hi - e_lo
        return cls(
            graph_key=getattr(graph, "key", None),
            num_vertices=nv,
            bounds=bounds,
            shards=tuple(shards),
            degree_mass=mass,
        )

    @property
    def num_domains(self) -> int:
        return len(self.shards)

    def shard_of(self, vertex: int) -> int:
        """Index of the shard owning ``vertex``. Duplicate bounds make some
        shards empty; ownership always resolves to the non-empty one."""
        if not 0 <= vertex < self.num_vertices:
            raise ValueError(f"vertex {vertex} outside [0, {self.num_vertices})")
        d = int(np.searchsorted(self.bounds, vertex, side="right")) - 1
        return min(max(d, 0), self.num_domains - 1)

    def domain_mass(
        self,
        vertices: np.ndarray | None = None,
        degrees: np.ndarray | None = None,
    ) -> np.ndarray:
        """Per-domain degree mass of a frontier ([D] float64).

        ``vertices`` are the frontier's vertex ids; ``degrees`` (optional,
        same length) weights each vertex — the same sampled per-vertex
        degrees preparation's local statistics use. ``vertices=None`` is a
        whole-graph frontier: the static per-shard degree mass."""
        if vertices is None:
            return self.degree_mass.astype(np.float64)
        vertices = np.asarray(vertices, dtype=np.int64)
        if vertices.size == 0:
            return np.zeros(self.num_domains, dtype=np.float64)
        shard_ids = np.clip(
            np.searchsorted(self.bounds, vertices, side="right") - 1,
            0,
            self.num_domains - 1,
        )
        if degrees is not None and len(degrees) == vertices.size:
            w = np.asarray(degrees, dtype=np.float64)
        else:
            w = None
        return np.bincount(
            shard_ids, weights=w, minlength=self.num_domains
        ).astype(np.float64)

    def dominant_domain(
        self,
        vertices: np.ndarray | None = None,
        degrees: np.ndarray | None = None,
    ) -> int:
        """The domain the frontier's degree mass touches most (ties → lowest
        index, so placement is deterministic)."""
        return int(np.argmax(self.domain_mass(vertices, degrees)))


def partition_graph(graph, domains: int) -> GraphPartition:
    """Convenience wrapper: :meth:`GraphPartition.build`."""
    return GraphPartition.build(graph, domains)
