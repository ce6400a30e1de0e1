"""Degree count: how often each id occurs among all edge endpoints, the
ids taken modulo the number of counters (``num_counters``, V when absent).
Compared exactly. The control keeps its counters in int16, the width below
the program's int32 (it wraps past 32,767: a hub of a scale-free graph
passes that).
"""
from __future__ import annotations

import torch

from graphbench.reference import GraphRef, GraphSizes

CHECKS = {"degree_count_mismatches": {"limit": 0, "combine": "sum"}}


def instances(query: dict, edges, seed: int):
    return [("degree_count", query.get("num_counters"))]


def make(port, graph, inst, stamped):
    return stamped(port.algorithms.DegreeCountExecutor)(graph, num_counters=inst[1])


def answer(executor) -> torch.Tensor:
    return executor._counters


def counts(ref: GraphRef, num_counters: int | None) -> torch.Tensor:
    c = int(num_counters or ref.num_vertices)
    return torch.bincount(torch.cat([ref.src, ref.dst]) % c, minlength=c)


def expected(ref: GraphRef, inst) -> torch.Tensor:
    return counts(ref, inst[1])


def control(ref: GraphRef, inst) -> torch.Tensor:
    return counts(ref, inst[1]).to(torch.int16)


def compare(got: torch.Tensor, want: torch.Tensor) -> dict[str, float]:
    return {"degree_count_mismatches": float((got.to(want.device, torch.int64) != want).sum())}


def work_edges(g: GraphSizes, inst, want) -> float:
    return float(g.num_edges)


def needed_bytes(g: GraphSizes, items) -> dict[str, float]:
    """Both int32 endpoint ids of every edge once for the round, and each
    query's int32 counters written."""
    c = sum(int(inst[1] or g.num_vertices) for inst, _ in items)
    return {"degree_count": 8.0 * g.num_edges + 4.0 * c}
