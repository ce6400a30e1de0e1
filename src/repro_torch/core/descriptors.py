"""Algorithm descriptors — the paper's "algorithmic properties" parameter set
(§4.1.1 type 2): per-item operation counts obtained by counting the ops the
processing lambdas execute. "In a productive system a query compiler could do
the counting automatically"; here each algorithm ships its descriptor as
static metadata, exactly as the paper stores them per algorithm.

Items follow Table 2: v (frontier vertex), e (traversed edge), f (newly found
vertex).
"""
from __future__ import annotations

import dataclasses
from typing import Literal

ItemKind = Literal["v", "e", "f"]


@dataclasses.dataclass(frozen=True)
class ItemCost:
    """Operation counts for processing one item (Table 2: N_ops/N_mem/N_atomics)."""

    n_ops: float = 0.0      # arithmetic operations
    n_mem: float = 0.0      # plain loads/stores
    n_atomics: float = 0.0  # atomic RMW (TPU: scatter-combine share)


@dataclasses.dataclass(frozen=True)
class AlgorithmDescriptor:
    """Static metadata for one algorithm variant.

    ``kind`` distinguishes the paper's preprocessing policy (§4.5):
    topology-centric (PR) prepares once, data-driven (BFS) prepares every
    iteration.
    ``push`` marks contention-prone scatter algorithms (atomics in parallel).
    ``bytes_per_touched`` sizes the shared, contended state per touched vertex
    (visited bits, rank cells, counters) — it scales M in L_atomic(T, M).
    ``bytes_per_vertex_private`` sizes streamed per-vertex state.
    """

    name: str
    kind: Literal["topology", "data_driven"]
    push: bool
    v: ItemCost
    e: ItemCost
    f: ItemCost
    bytes_per_touched: int = 4
    bytes_per_vertex_private: int = 8

    def item(self, which: ItemKind) -> ItemCost:
        """Per-item cost row: ``"v"`` (vertex), ``"e"`` (edge), ``"f"`` (found)."""
        return {"v": self.v, "e": self.e, "f": self.f}[which]


# ---------------------------------------------------------------------------
# Descriptors for the evaluated algorithms. Counts were obtained by counting
# the ops of the corresponding lambdas in repro.algorithms (see each module's
# docstring for the count audit).
# ---------------------------------------------------------------------------

BFS_TOP_DOWN = AlgorithmDescriptor(
    name="bfs_top_down",
    kind="data_driven",
    push=True,
    # per frontier vertex: read indptr range (2 loads) + loop bookkeeping
    v=ItemCost(n_ops=2, n_mem=2, n_atomics=0),
    # per edge: load neighbour id, load visited flag, compare
    e=ItemCost(n_ops=1, n_mem=2, n_atomics=0),
    # per found vertex: CAS on visited + write parent/next-frontier slot
    f=ItemCost(n_ops=1, n_mem=1, n_atomics=1),
    bytes_per_touched=1,          # visited bitmap/byte per touched vertex
    bytes_per_vertex_private=8,   # queue slot + parent
)

PR_PUSH = AlgorithmDescriptor(
    name="pagerank_push",
    kind="topology",
    push=True,
    # per vertex: load rank, divide by degree (1 div ~ 4 ops), store contrib
    v=ItemCost(n_ops=4, n_mem=2, n_atomics=0),
    # per edge: atomic add of contribution into target accumulator
    e=ItemCost(n_ops=1, n_mem=1, n_atomics=1),
    # PR has no "found" set; f unused
    f=ItemCost(),
    bytes_per_touched=8,          # fp64/fp32 accumulator per touched vertex
    bytes_per_vertex_private=16,
)

PR_PULL = AlgorithmDescriptor(
    name="pagerank_pull",
    kind="topology",
    push=False,
    # per vertex: accumulate + damping (mul/add), store new rank
    v=ItemCost(n_ops=4, n_mem=2, n_atomics=0),
    # per edge: load source contrib + add (no atomics: each target owned)
    e=ItemCost(n_ops=1, n_mem=1, n_atomics=0),
    f=ItemCost(),
    bytes_per_touched=4,
    bytes_per_vertex_private=16,
)

DEGREE_COUNT = AlgorithmDescriptor(
    name="degree_count",
    kind="topology",
    push=True,
    v=ItemCost(n_ops=0, n_mem=0, n_atomics=0),
    # per edge: two fetch-and-adds (source + target counter), §5.1
    e=ItemCost(n_ops=0, n_mem=0, n_atomics=2),
    f=ItemCost(),
    bytes_per_touched=4,          # sizeof(counter): Eq. (11)
    bytes_per_vertex_private=0,
)


REGISTRY: dict[str, AlgorithmDescriptor] = {
    d.name: d
    for d in (BFS_TOP_DOWN, PR_PUSH, PR_PULL, DEGREE_COUNT)
}
