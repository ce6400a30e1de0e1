"""RMAT graph generator (Graph500-style), used by the paper for synthetic data
and as the calibration data set for the contention model (§5.1: "RMAT is
chosen as being representative ... scale-free degree distribution causes high
contention").

Pure numpy for speed and determinism; edge factor 16 as in Graph500. The
``*_graph`` builders place the finished graph on ``device`` (the card unless
the caller names another, see ``structure.resolve_device``).
"""
from __future__ import annotations

import numpy as np

from .structure import Graph, build_graph

# Graph500 default RMAT parameters.
A, B, C = 0.57, 0.19, 0.19


def rmat_edges(
    scale: int,
    edge_factor: int = 16,
    *,
    seed: int = 0,
    a: float = A,
    b: float = B,
    c: float = C,
) -> tuple[np.ndarray, np.ndarray]:
    """Generate an RMAT edge list with 2**scale vertices."""
    rng = np.random.default_rng(seed)
    n_vertices = 1 << scale
    n_edges = n_vertices * edge_factor
    src = np.zeros(n_edges, dtype=np.int64)
    dst = np.zeros(n_edges, dtype=np.int64)
    ab, abc = a + b, a + b + c
    for bit in range(scale):
        r = rng.random(n_edges)
        go_right = (r >= a) & (r < ab)          # quadrant B: dst bit set
        go_down = (r >= ab) & (r < abc)         # quadrant C: src bit set
        go_diag = r >= abc                      # quadrant D: both set
        src |= ((go_down | go_diag) << bit).astype(np.int64)
        dst |= ((go_right | go_diag) << bit).astype(np.int64)
    # permute vertex IDs so locality is not an artefact of generation order
    perm = rng.permutation(n_vertices)
    return perm[src], perm[dst]


def rmat_graph(
    scale: int, edge_factor: int = 16, *, seed: int = 0, name: str | None = None, device=None
) -> Graph:
    src, dst = rmat_edges(scale, edge_factor, seed=seed)
    return build_graph(
        src, dst, 1 << scale, name=name or f"rmat_sf{scale}", surrogate=False, device=device
    )


def uniform_random_graph(
    n_vertices: int, n_edges: int, *, seed: int = 0, name: str = "uniform", device=None
) -> Graph:
    """Erdős–Rényi-style uniform random graph (near-constant expected degree)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_vertices, size=n_edges, dtype=np.int64)
    dst = rng.integers(0, n_vertices, size=n_edges, dtype=np.int64)
    return build_graph(src, dst, n_vertices, name=name, device=device)


def clustered_graph(
    scale: int,
    clusters: int,
    edge_factor: int = 16,
    *,
    seed: int = 0,
    cross_fraction: float = 0.02,
    name: str | None = None,
    device=None,
) -> Graph:
    """Block-structured graph: ``clusters`` contiguous RMAT communities of
    ``2**scale`` vertices each, plus a ``cross_fraction`` share of uniform
    cross-community edges.

    Community ``k`` owns the contiguous vertex range
    ``[k * 2**scale, (k+1) * 2**scale)``, so a contiguous degree-balanced
    partition (graph.partition) recovers the communities almost exactly —
    the natural stress case for locality domains: a traversal seeded inside
    one community keeps its frontier's degree mass on one shard, and
    placement either exploits that or pays the interconnect."""
    block = 1 << scale
    n_vertices = clusters * block
    srcs, dsts = [], []
    for k in range(clusters):
        s, d = rmat_edges(scale, edge_factor, seed=seed + k)
        srcs.append(s + k * block)
        dsts.append(d + k * block)
    n_cross = int(cross_fraction * clusters * block * edge_factor)
    if n_cross > 0:
        rng = np.random.default_rng(seed + 7919)
        srcs.append(rng.integers(0, n_vertices, size=n_cross, dtype=np.int64))
        dsts.append(rng.integers(0, n_vertices, size=n_cross, dtype=np.int64))
    src = np.concatenate(srcs)
    dst = np.concatenate(dsts)
    return build_graph(
        src,
        dst,
        n_vertices,
        name=name or f"clustered_sf{scale}x{clusters}",
        surrogate=False,
        device=device,
    )


def grid_graph(side: int, *, name: str = "grid", device=None) -> Graph:
    """2-D grid / road-network-like graph: constant degree ≤ 4, long diameter."""
    n = side * side
    ii, jj = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    vid = (ii * side + jj).astype(np.int64)
    edges_src, edges_dst = [], []
    # 4-neighbourhood, both directions
    right_s, right_d = vid[:, :-1].ravel(), vid[:, 1:].ravel()
    down_s, down_d = vid[:-1, :].ravel(), vid[1:, :].ravel()
    edges_src += [right_s, right_d, down_s, down_d]
    edges_dst += [right_d, right_s, down_d, down_s]
    src = np.concatenate(edges_src)
    dst = np.concatenate(edges_dst)
    return build_graph(src, dst, n, name=name, device=device)
