"""Graph data structures.

CSR is the primary topology index (the paper's "adjacency list"); statistics
required by the cost model (§4.1.2) are gathered *during construction* so that
they are free at query time. Construction runs on the host in numpy (the same
edges give the same arrays as the JAX package); the finished arrays are int32
tensors on the device the caller chose.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names
    another. With no CUDA and no explicit device this raises instead of
    quietly running on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")


def seeded_generator(device: torch.device, seed: int) -> torch.Generator | None:
    """A generator on ``device`` seeded with ``seed``, for a model's initial
    draws; ``None`` on ``meta``, which has no generator: a meta tensor holds
    no numbers, so its draws are shape-only and a model built there has the
    shapes and dtypes of one built on a device."""
    return None if device.type == "meta" else torch.Generator(device=device).manual_seed(seed)


@dataclasses.dataclass(frozen=True)
class CSRGraph:
    """Compressed-sparse-row adjacency (out-edges).

    indptr:  [V+1] int32 — row offsets.
    indices: [E]   int32 — destination vertex of each out-edge.
    """

    indptr: torch.Tensor
    indices: torch.Tensor

    @property
    def num_vertices(self) -> int:
        return int(self.indptr.shape[0]) - 1

    @property
    def num_edges(self) -> int:
        return int(self.indices.shape[0])

    def out_degrees(self) -> torch.Tensor:
        return self.indptr[1:] - self.indptr[:-1]

    def edge_sources(self) -> torch.Tensor:
        """[E] int32 source vertex per edge (CSR row expansion)."""
        v = self.num_vertices
        rows = torch.arange(v, dtype=torch.int32, device=self.indptr.device)
        return torch.repeat_interleave(
            rows, self.out_degrees().to(torch.int64), output_size=self.num_edges
        )


@dataclasses.dataclass(frozen=True)
class GraphStats:
    """Construction-time statistics (paper §4.1.2, Table 1).

    Gathered while the adjacency index is built; used by the estimators and
    the cost model without touching the graph again.
    """

    num_vertices: int
    num_edges: int
    v_reach: int            # |V_reach|: neither isolated nor without in-edge
    deg_out_mean: float     # mean out-degree over all vertices
    deg_out_max: int        # max out-degree
    deg_in_mean: float
    deg_in_max: int
    # degree variance indicator used by §4.1.2 (threshold 1.1)
    @property
    def degree_variance_ratio(self) -> float:
        if self.deg_out_mean <= 0:
            return 1.0
        return float(self.deg_out_max) / float(self.deg_out_mean)


@dataclasses.dataclass(frozen=True)
class Graph:
    """A graph bundle: out-CSR, in-CSR (for pull), COO views, and stats.

    The views every query's executor reads (in-edge targets, int32
    out-degrees, host copies of both degree vectors) are derived once, on
    first use, and shared read-only by every executor on the graph."""

    csr: CSRGraph                  # out-edges (push / BFS top-down)
    csr_in: CSRGraph               # in-edges  (pull PR)
    src: torch.Tensor              # [E] COO source (sorted by src)
    dst: torch.Tensor              # [E] COO destination
    stats: GraphStats
    name: str = "graph"
    surrogate: bool = False        # True when standing in for a SNAP dataset
    epoch: int = 0                 # snapshot generation

    @property
    def num_vertices(self) -> int:
        return self.csr.num_vertices

    @property
    def num_edges(self) -> int:
        return self.csr.num_edges

    @property
    def device(self) -> torch.device:
        return self.src.device

    @functools.cached_property
    def key(self) -> tuple:
        """Stable identity for same-graph co-scheduling (steal locality,
        gang fusion, the backend's per-graph device tables): the name, the
        snapshot epoch and construction-time statistics, all Python ints, so
        two separately loaded copies of one dataset share one key."""
        s = self.stats
        return (
            self.name,
            self.epoch,
            s.num_vertices,
            s.num_edges,
            s.deg_out_max,
            s.deg_in_max,
            s.v_reach,
        )

    def out_degrees(self) -> torch.Tensor:
        return self.csr.out_degrees()

    def in_degrees(self) -> torch.Tensor:
        return self.csr_in.out_degrees()

    @functools.cached_property
    def in_targets(self) -> torch.Tensor:
        """[E] int32 target of each in-edge, in in-CSR order (ascending)."""
        return self.csr_in.edge_sources()

    @functools.cached_property
    def out_deg(self) -> torch.Tensor:
        """[V] int32 out-degrees on the graph's device."""
        return self.out_degrees().to(torch.int32)

    @functools.cached_property
    def out_deg_host(self) -> np.ndarray:
        """[V] out-degrees on the host (read-only)."""
        return _host_copy(self.out_deg)

    @functools.cached_property
    def in_deg_host(self) -> np.ndarray:
        """[V] in-degrees on the host (read-only)."""
        return _host_copy(self.in_degrees())


def _host_copy(t: torch.Tensor) -> np.ndarray:
    from ..core import tracing  # here: the core package imports this module

    a = tracing.host_read(t).numpy()
    a.flags.writeable = False
    return a


def _csr_from_coo_np(src: np.ndarray, dst: np.ndarray, num_vertices: int):
    order = np.argsort(src, kind="stable")
    src_s = src[order]
    dst_s = dst[order]
    counts = np.bincount(src_s, minlength=num_vertices).astype(np.int64)
    indptr = np.zeros(num_vertices + 1, dtype=np.int64)
    np.cumsum(counts, out=indptr[1:])
    return indptr.astype(np.int32), dst_s.astype(np.int32), src_s.astype(np.int32)


def graph_from_arrays(
    indptr,
    indices,
    indptr_in,
    indices_in,
    src,
    dst,
    stats: dict,
    *,
    name: str = "graph",
    surrogate: bool = False,
    epoch: int = 0,
    device=None,
) -> Graph:
    """Build a :class:`Graph` from finished host arrays (CSR out/in, COO in
    out-edge order, the ``GraphStats`` fields as a dict). This carries a
    graph built elsewhere across unchanged: the same arrays give the same
    topology and the same ``key``."""
    dev = resolve_device(device)

    def t(a) -> torch.Tensor:
        # a copy: the graph never aliases (or writes through to) caller memory
        return torch.from_numpy(np.array(a, dtype=np.int32)).to(dev)

    return Graph(
        csr=CSRGraph(t(indptr), t(indices)),
        csr_in=CSRGraph(t(indptr_in), t(indices_in)),
        src=t(src),
        dst=t(dst),
        stats=GraphStats(**stats),
        name=name,
        surrogate=surrogate,
        epoch=int(epoch),
    )


def build_graph(
    src,
    dst,
    num_vertices: int,
    *,
    name: str = "graph",
    dedup: bool = False,
    surrogate: bool = False,
    device=None,
) -> Graph:
    """Build the full graph bundle + stats from a COO edge list.

    Statistics are collected during this construction pass (paper §4.1.2):
    out/in degree mean & max, and |V_reach| (vertices that are neither
    isolated nor lacking an incoming edge — the paper's approximation).
    With tracing on (``core.tracing``) the build is a ``graph.build`` span,
    with a ``graph.csr`` span for each CSR sort and ``graph.upload`` for
    the copy to the device.
    """
    from ..core import tracing  # here: the core package imports this module

    with tracing.span("graph.build"):
        dev = resolve_device(device)
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        if src.ndim != 1 or src.shape != dst.shape:
            raise ValueError("src/dst must be 1-D arrays of equal length")
        if src.size and (src.min() < 0 or src.max() >= num_vertices):
            raise ValueError("src out of range")
        if dst.size and (dst.min() < 0 or dst.max() >= num_vertices):
            raise ValueError("dst out of range")
        if dedup and src.size:
            key = src * num_vertices + dst
            _, keep = np.unique(key, return_index=True)
            src, dst = src[keep], dst[keep]

        with tracing.span("graph.csr"):
            indptr, indices, src_sorted = _csr_from_coo_np(src, dst, num_vertices)
        with tracing.span("graph.csr"):
            indptr_in, indices_in, _ = _csr_from_coo_np(dst, src, num_vertices)

        out_deg = np.diff(indptr)
        in_deg = np.diff(indptr_in)
        has_in = in_deg > 0
        isolated = (out_deg == 0) & (in_deg == 0)
        v_reach = int(np.count_nonzero(has_in & ~isolated))

        stats = dict(
            num_vertices=int(num_vertices),
            num_edges=int(src.size),
            v_reach=max(v_reach, 1),
            deg_out_mean=float(out_deg.mean()) if num_vertices else 0.0,
            deg_out_max=int(out_deg.max()) if num_vertices else 0,
            deg_in_mean=float(in_deg.mean()) if num_vertices else 0.0,
            deg_in_max=int(in_deg.max()) if num_vertices else 0,
        )
        # dst in out-edge order is the out-CSR's index array (already sorted by src)
        with tracing.span("graph.upload"):
            return graph_from_arrays(
                indptr, indices, indptr_in, indices_in, src_sorted, indices, stats,
                name=name, surrogate=surrogate, device=dev,
            )


def pad_edges(src: torch.Tensor, dst: torch.Tensor, multiple: int, fill: int):
    """Pad a COO edge list to a multiple (static-shape work packages)."""
    e = src.shape[0]
    target = ((e + multiple - 1) // multiple) * multiple
    pad = target - e
    if pad == 0:
        return src, dst, e
    src = torch.cat([src, torch.full((pad,), fill, dtype=src.dtype, device=src.device)])
    dst = torch.cat([dst, torch.full((pad,), fill, dtype=dst.dtype, device=dst.device)])
    return src, dst, e
