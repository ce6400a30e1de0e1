"""Epoch-snapshot semantics for dynamic graphs.

The paper schedules queries over static graphs; the most production-shaped
workload beyond it is a *live ingest stream* — a writer applying edge
batches while reader queries run concurrently. :class:`GraphEpochLog` is
the graph-layer half of that story:

* the log accepts streamed edge batches (:meth:`append`) against a base
  :class:`~repro_torch.graph.structure.Graph`;
* :meth:`publish` freezes the accumulated edges into a brand-new immutable
  ``Graph`` snapshot whose ``epoch`` is one greater than the previous
  snapshot's, with its degree statistics *delta-updated* by a
  :class:`~repro_torch.graph.sampler.DegreeStatTracker` (O(batch), not
  O(V+E));
* readers that started on an older snapshot keep their ``Graph`` object —
  snapshots share no mutable state, so "readers pin, writers publish" is
  structural, not a locking discipline.

Because ``epoch`` is a component of ``Graph.key``, every identity-keyed
runtime structure — fusion rendezvous, steal locality ranking, the shared
prep cache, ``GraphPartition`` shard views, the backend's per-graph
device tables — distinguishes snapshots automatically: stale entries are simply
never looked up again, and no gang can mix members on different snapshots.

The log is a host-side, single-writer structure: the engine applies
batches between events (``EV_INGEST``), so no concurrency control is
needed beyond the immutability of the published snapshots. The cumulative
edge list stays on the host and is sorted there; each snapshot's tensors go
to the base graph's device.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .sampler import DegreeStatTracker
from .structure import Graph, _csr_from_coo_np, graph_from_arrays


class GraphEpochLog:
    """Accumulate streamed edge batches; publish immutable epoch snapshots.

    ``GraphEpochLog(base)`` starts at ``base``'s epoch (0 for a freshly
    built graph). ``append(src, dst)`` buffers a batch; ``publish()``
    rebuilds the CSR bundle over *all* edges seen so far and returns the
    new snapshot (a no-op returning the current snapshot when nothing is
    pending). ``ingest(src, dst)`` is the common append-then-publish step.
    Every snapshot lies on the base graph's device.
    """

    def __init__(self, base: Graph) -> None:
        self._snapshot = base
        self._device = base.device
        self._tracker = DegreeStatTracker(base)
        # cumulative COO on the host; base arrays are already src-sorted,
        # which _csr_from_coo_np's stable sort preserves cheaply.
        self._src: list[np.ndarray] = [base.src.cpu().numpy().astype(np.int64)]
        self._dst: list[np.ndarray] = [base.dst.cpu().numpy().astype(np.int64)]
        self._pending_src: list[np.ndarray] = []
        self._pending_dst: list[np.ndarray] = []

    @property
    def epoch(self) -> int:
        """Epoch of the current (latest published) snapshot."""
        return self._snapshot.epoch

    @property
    def pending_edges(self) -> int:
        """Edges appended since the last publish."""
        return int(sum(a.size for a in self._pending_src))

    def current(self) -> Graph:
        """The latest published snapshot (immutable)."""
        return self._snapshot

    def append(self, src, dst) -> int:
        """Buffer one edge batch; returns the pending edge count.

        Batches are validated against the base vertex set — ingest adds
        edges, not vertices (growing ``V`` would invalidate every reader's
        fixed-shape state; pre-size the base graph instead).
        """
        src = np.asarray(src, dtype=np.int64).ravel()
        dst = np.asarray(dst, dtype=np.int64).ravel()
        if src.shape != dst.shape:
            raise ValueError("src/dst must be 1-D arrays of equal length")
        v = self._snapshot.num_vertices
        if src.size and (src.min() < 0 or src.max() >= v):
            raise ValueError("src out of range")
        if dst.size and (dst.min() < 0 or dst.max() >= v):
            raise ValueError("dst out of range")
        if src.size:
            self._pending_src.append(src)
            self._pending_dst.append(dst)
        return self.pending_edges

    def publish(self) -> Graph:
        """Freeze pending batches into a new immutable snapshot.

        The CSR bundle is rebuilt over the cumulative edge list (sorting is
        the unavoidable cost of an index usable by static-shape kernels);
        the statistics are delta-updated from the batch alone. With no
        pending edges this is a no-op returning the current snapshot — the
        epoch only advances when the topology actually changed.
        """
        if not self._pending_src:
            return self._snapshot
        bsrc = np.concatenate(self._pending_src)
        bdst = np.concatenate(self._pending_dst)
        self._pending_src, self._pending_dst = [], []
        self._tracker.add(bsrc, bdst)
        self._src.append(bsrc)
        self._dst.append(bdst)
        src = np.concatenate(self._src)
        dst = np.concatenate(self._dst)
        self._src, self._dst = [src], [dst]
        v = self._snapshot.num_vertices
        indptr, indices, src_sorted = _csr_from_coo_np(src, dst, v)
        indptr_in, indices_in, _ = _csr_from_coo_np(dst, src, v)
        prev = self._snapshot
        # dst in out-edge order is the out-CSR's index array
        self._snapshot = graph_from_arrays(
            indptr, indices, indptr_in, indices_in, src_sorted, indices,
            dataclasses.asdict(self._tracker.stats()),
            name=prev.name,
            surrogate=prev.surrogate,
            epoch=prev.epoch + 1,
            device=self._device,
        )
        return self._snapshot

    def ingest(self, src, dst) -> Graph:
        """Append one batch and immediately publish the next snapshot."""
        self.append(src, dst)
        return self.publish()
