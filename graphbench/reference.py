"""The plain reference: the graph as the benchmark itself holds it.

Built from the benchmark's own edge list, in plain PyTorch, on whatever
device the edge list is on. It imports nothing of the program and takes
nothing the program built: the query kinds (``queries/<kind>.py``) compute
their expected answers, their controls and their work from it.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class GraphSizes:
    """What the work and byte counts read of the graph, held on the host
    so that the reference can be freed before the window."""

    num_vertices: int
    num_edges: int
    out_deg: torch.Tensor


class GraphRef:
    """Degrees and an out-CSR of one directed edge list (int64 ids)."""

    def __init__(self, src: torch.Tensor, dst: torch.Tensor, num_vertices: int):
        self.num_vertices = int(num_vertices)
        self.src = src.to(torch.int64)
        self.dst = dst.to(torch.int64)
        self.num_edges = int(self.src.shape[0])
        v = self.num_vertices
        self.out_deg = torch.bincount(self.src, minlength=v)
        self.in_deg = torch.bincount(self.dst, minlength=v)
        order = torch.argsort(self.src, stable=True)
        self.out_idx = self.dst[order]
        self.out_ptr = torch.zeros(v + 1, dtype=torch.int64, device=self.src.device)
        torch.cumsum(self.out_deg, 0, out=self.out_ptr[1:])

    def sizes(self) -> GraphSizes:
        return GraphSizes(self.num_vertices, self.num_edges, self.out_deg.cpu())

    def neighbours(self, frontier: torch.Tensor) -> torch.Tensor:
        """Every out-neighbour of the vertices in ``frontier`` (with
        repeats), gathered from the out-CSR."""
        starts = self.out_ptr[frontier]
        counts = self.out_ptr[frontier + 1] - starts
        total = int(counts.sum())
        if total == 0:
            return frontier.new_empty(0)
        first = torch.cumsum(counts, 0) - counts
        offs = torch.repeat_interleave(starts - first, counts, output_size=total)
        offs += torch.arange(total, device=offs.device)
        return self.out_idx[offs]
