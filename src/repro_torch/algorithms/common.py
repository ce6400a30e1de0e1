"""Shared machinery for the graph algorithm executors.

All algorithms are *edge-centric*: work is vectorized over the edge list, not
over a vertex loop. Work packages select a *slot range* of the compacted
frontier; membership is materialized as a dense vertex mask, so one program
serves every package and a package costs no host round trip.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np
import torch

from ..graph.structure import Graph


@dataclasses.dataclass(frozen=True)
class EdgeArrays:
    """Device-resident edge-centric views of a graph, shared by every
    executor on it: read-only."""

    src: torch.Tensor          # [E] int32, sorted by src (out-edge order)
    dst: torch.Tensor          # [E] int32
    in_src: torch.Tensor       # [E] int32, in-edge order (sorted by target)
    in_dst: torch.Tensor       # [E] int32 (the targets; sorted ascending)
    out_deg: torch.Tensor      # [V] int32
    num_vertices: int
    num_edges: int

    @classmethod
    def from_graph(cls, g: Graph) -> "EdgeArrays":
        """Views of the graph's own arrays: nothing is copied."""
        return cls(
            src=g.src,
            dst=g.dst,
            in_src=g.csr_in.indices,      # in-CSR indices = original sources
            in_dst=g.in_targets,
            out_deg=g.out_deg,
            num_vertices=g.num_vertices,
            num_edges=g.num_edges,
        )


def member_mask_from_slots(
    frontier_list: torch.Tensor,  # [V] int32, compacted frontier padded with V
    n_frontier: int,
    lo: int,                      # slot range [lo, hi)
    hi: int,
    num_vertices: int,
) -> torch.Tensor:
    """Dense [V] bool mask of the vertices in frontier slots [lo, hi)."""
    lo, hi = max(lo, 0), min(hi, n_frontier)
    mask = torch.zeros(num_vertices, dtype=torch.bool, device=frontier_list.device)
    if hi > lo:
        # slots below n_frontier hold distinct vertex ids (< V)
        mask[frontier_list[lo:hi].to(torch.int64)] = True
    return mask


def merge_ranges(bounds: np.ndarray, package_ids: Iterable[int]) -> list[tuple[int, int]]:
    """Merge an (arbitrary-order) set of package ids into minimal contiguous
    slot ranges, preserving the order of first appearance of each run."""
    ids = sorted(int(p) for p in package_ids)
    ranges: list[tuple[int, int]] = []
    for p in ids:
        lo, hi = int(bounds[p]), int(bounds[p + 1])
        if ranges and ranges[-1][1] == lo:
            ranges[-1] = (ranges[-1][0], hi)
        else:
            ranges.append((lo, hi))
    return ranges


def compact_frontier(mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Compact a [V] bool mask into a padded vertex list + count.

    The list holds the set vertices in ascending id order (the order
    package bounds and their modeled costs depend on), then the pad value V.
    Built by a prefix sum and a scatter, so it needs no host sync."""
    v = mask.shape[0]
    pos = torch.cumsum(mask, 0, dtype=torch.int64) - 1
    slot = torch.where(mask, pos, torch.full_like(pos, v))
    out = torch.full((v + 1,), v, dtype=torch.int32, device=mask.device)
    # only the discarded pad slot v receives more than one write
    out[slot] = torch.arange(v, dtype=torch.int32, device=mask.device)
    return out[:v], mask.sum(dtype=torch.int32)
