"""Graph statistics sampling: GNN fanout blocks and incremental re-stats.

Two kinds of sampling live here:

* A fanout sampler (GraphSAGE-style): given seed nodes and per-hop fanouts
  (e.g. 15, 10), sample up to ``fanout`` neighbours per node per hop,
  producing a fixed-shape (padded) subgraph block. Sampling runs on the
  host in numpy (the same seed gives the same picks as the JAX package);
  :func:`block_to_device` moves a block onto the device as tensors.

* :class:`DegreeStatTracker` — incremental re-sampling of the
  construction-time degree statistics (§4.1.2) under streamed edge ingest.
  ``build_graph`` gathers ``GraphStats`` in one O(V+E) pass; a
  ``GraphEpochLog`` publishing a snapshot per edge batch cannot afford that
  pass per epoch, so the tracker delta-updates the stats from the batch
  alone. Under append-only ingest the update is *exact*, not approximate:
  degree means are ``|E| / |V|`` by definition, degrees only ever grow so
  the new maxima can only come from batch-touched vertices, and
  ``v_reach`` (vertices with an in-edge — having one implies non-isolated)
  grows exactly by the batch destinations whose in-degree crossed 0.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .structure import Graph, GraphStats, resolve_device


class DegreeStatTracker:
    """Delta-update ``GraphStats`` across streamed edge batches.

    Seeded from a base :class:`Graph` (on any device), the tracker keeps
    host-side out/in degree arrays plus the running edge count, degree
    maxima, and reach count. :meth:`add` folds one edge batch in at
    O(batch) cost; :meth:`stats` materializes the ``GraphStats`` for the
    next snapshot.

    The invariants that make the delta exact:

    * ingest is append-only, so per-vertex degrees are monotone — a new
      maximum must belong to a vertex the batch touched;
    * ``deg_*_mean`` is ``num_edges / num_vertices`` exactly, so the means
      follow from the edge count alone;
    * a vertex with an in-edge is by definition not isolated, so
      ``v_reach == count(in_deg > 0)`` and it grows exactly by the batch
      destinations whose in-degree crossed zero.

    Duplicate edges are *kept* (matching ``build_graph(dedup=False)``, the
    epoch log's construction mode); a deduplicating ingest path would break
    the append-only degree monotonicity argument and needs the full pass.
    """

    def __init__(self, graph: Graph) -> None:
        self._out = graph.csr.out_degrees().cpu().numpy().astype(np.int64)
        self._in = graph.csr_in.out_degrees().cpu().numpy().astype(np.int64)
        s = graph.stats
        self._v = int(s.num_vertices)
        self._edges = int(s.num_edges)
        self._out_max = int(s.deg_out_max)
        self._in_max = int(s.deg_in_max)
        # raw reach count (GraphStats stores it clamped to >= 1)
        self._reach = int(np.count_nonzero(self._in > 0))

    def add(self, src: np.ndarray, dst: np.ndarray) -> None:
        """Fold one edge batch into the tracked degree state."""
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        if src.size == 0:
            return
        us, cs = np.unique(src, return_counts=True)
        self._out[us] += cs
        self._out_max = max(self._out_max, int(self._out[us].max()))
        ud, cd = np.unique(dst, return_counts=True)
        self._reach += int(np.count_nonzero(self._in[ud] == 0))
        self._in[ud] += cd
        self._in_max = max(self._in_max, int(self._in[ud].max()))
        self._edges += int(src.size)

    def stats(self) -> GraphStats:
        """The delta-updated statistics for the current edge total."""
        v = self._v
        mean = float(self._edges) / v if v else 0.0
        return GraphStats(
            num_vertices=v,
            num_edges=self._edges,
            v_reach=max(self._reach, 1),
            deg_out_mean=mean,
            deg_out_max=self._out_max,
            deg_in_mean=mean,
            deg_in_max=self._in_max,
        )


@dataclasses.dataclass(frozen=True)
class SampledBlock:
    """A fixed-shape sampled subgraph (host arrays).

    nodes:    [max_nodes] int32 global node ids (padded with -1)
    num_nodes: int — valid prefix length
    src/dst:  [max_edges] int32 *local* indices into ``nodes`` (padded -1)
    num_edges: int
    seeds:    [batch] int32 local indices of the seed nodes (always the prefix)
    """

    nodes: np.ndarray
    num_nodes: int
    src: np.ndarray
    dst: np.ndarray
    num_edges: int
    seeds: np.ndarray

    @property
    def max_nodes(self) -> int:
        return int(self.nodes.shape[0])

    @property
    def max_edges(self) -> int:
        return int(self.src.shape[0])


def plan_capacity(batch_nodes: int, fanouts: tuple[int, ...]) -> tuple[int, int]:
    """Worst-case node/edge capacity for a fanout plan (static shapes)."""
    nodes = batch_nodes
    total_nodes = batch_nodes
    total_edges = 0
    for f in fanouts:
        edges = nodes * f
        total_edges += edges
        nodes = edges
        total_nodes += nodes
    return total_nodes, total_edges


def sample_fanout(
    graph: Graph,
    seeds: np.ndarray,
    fanouts: tuple[int, ...],
    *,
    seed: int = 0,
) -> SampledBlock:
    """Sample a k-hop fanout subgraph around ``seeds`` (host-side, numpy).

    Sampling is *without replacement per node* when degree >= fanout, else all
    neighbours are taken. Returns local-indexed, padded COO.
    """
    rng = np.random.default_rng(seed)
    indptr = graph.csr.indptr.cpu().numpy()
    indices = graph.csr.indices.cpu().numpy()

    seeds = np.asarray(seeds, dtype=np.int64)
    max_nodes, max_edges = plan_capacity(len(seeds), fanouts)

    node_ids: list[int] = list(seeds)
    local_of = {int(g): i for i, g in enumerate(seeds)}
    src_l: list[int] = []
    dst_l: list[int] = []

    frontier = list(seeds)
    for f in fanouts:
        next_frontier: list[int] = []
        for u in frontier:
            lo, hi = int(indptr[u]), int(indptr[u + 1])
            deg = hi - lo
            if deg == 0:
                continue
            if deg <= f:
                picks = indices[lo:hi]
            else:
                picks = indices[lo + rng.choice(deg, size=f, replace=False)]
            lu = local_of[int(u)]
            for v in picks:
                vi = int(v)
                lv = local_of.get(vi)
                if lv is None:
                    lv = len(node_ids)
                    local_of[vi] = lv
                    node_ids.append(vi)
                    next_frontier.append(vi)
                # message flows neighbour -> node (dst = the sampled-for node)
                src_l.append(lv)
                dst_l.append(lu)
        frontier = next_frontier

    n_nodes = len(node_ids)
    n_edges = len(src_l)
    nodes = np.full(max_nodes, -1, dtype=np.int32)
    nodes[:n_nodes] = np.asarray(node_ids, dtype=np.int32)
    src = np.full(max_edges, -1, dtype=np.int32)
    dst = np.full(max_edges, -1, dtype=np.int32)
    src[:n_edges] = np.asarray(src_l, dtype=np.int32)
    dst[:n_edges] = np.asarray(dst_l, dtype=np.int32)
    return SampledBlock(
        nodes=nodes,
        num_nodes=n_nodes,
        src=src,
        dst=dst,
        num_edges=n_edges,
        seeds=np.arange(len(seeds), dtype=np.int32),
    )


def block_to_device(block: SampledBlock, *, device=None) -> dict:
    """A SampledBlock as tensors on ``device`` (the card unless the caller
    names another): int32 ids with padding (-1) replaced by 0, and bool
    masks marking the valid nodes and edges."""
    dev = resolve_device(device)
    edge_mask = block.src >= 0
    src = np.where(edge_mask, block.src, 0).astype(np.int32)
    dst = np.where(edge_mask, block.dst, 0).astype(np.int32)
    node_mask = block.nodes >= 0

    def t(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return dict(
        nodes=t(np.where(node_mask, block.nodes, 0).astype(np.int32)),
        node_mask=t(node_mask),
        src=t(src),
        dst=t(dst),
        edge_mask=t(edge_mask),
        seeds=t(block.seeds.astype(np.int32)),
    )
