"""PageRank, pull direction, a fixed number of iterations (``tol`` 0).

The reference follows the program's rule in float64: ranks start at 1/V;
a vertex with out-edges passes rank/out-degree along each of them; the rank
of vertices without out-edges (dangling) is spread evenly over all V;
``rank' = (1 - d)/V + d * (in-sum + dangling/V)``.

Compared: the largest relative error of any vertex's rank against the
float64 reference, over every PageRank answer of the run. The control
(``control``) is the same reference with its rank and contribution vectors
held in bfloat16 (sums in float32): the precision below the program's
float32 that would halve the bytes a sweep gathers.
"""
from __future__ import annotations

import torch

from graphbench.reference import GraphRef, GraphSizes

DAMPING = 0.85
# Set from the readings in PERF.md: the program's largest reading over its
# seeds, against the bfloat16 control's smallest.
CHECKS = {"pagerank_max_rel_err": {"limit": 1e-4, "combine": "max"}}


def instances(query: dict, edges, seed: int):
    """Every session asks the same question: one instance."""
    return [("pagerank_pull", int(query["max_iters"]), float(query["tol"]))]


def make(port, graph, inst, stamped):
    _, iters, tol = inst
    cls = stamped(port.algorithms.PageRankExecutor)
    return cls(graph, mode="pull", max_iters=iters, tol=tol)


def answer(executor) -> torch.Tensor:
    """The ranks the query ended with (a device tensor, not copied)."""
    return executor._rank


def ranks(ref: GraphRef, iters: int, dtype=torch.float64, store=None) -> torch.Tensor:
    """``iters`` pull iterations; with ``store`` the vectors are rounded to
    that type after every computation (the control)."""
    v = ref.num_vertices
    has_out = ref.out_deg > 0
    deg = ref.out_deg.clamp(min=1).to(dtype)
    rank = torch.full((v,), 1.0 / v, dtype=dtype, device=ref.src.device)
    for _ in range(iters):
        contrib = torch.where(has_out, rank / deg, 0.0)
        dangling = rank[~has_out].sum()
        if store is not None:
            contrib = contrib.to(store).to(dtype)
        acc = torch.zeros(v, dtype=dtype, device=rank.device)
        acc.index_add_(0, ref.dst, contrib[ref.src])
        rank = (1.0 - DAMPING) / v + DAMPING * (acc + dangling / v)
        if store is not None:
            rank = rank.to(store).to(dtype)
    return rank


def expected(ref: GraphRef, inst) -> torch.Tensor:
    return ranks(ref, inst[1])


def control(ref: GraphRef, inst) -> torch.Tensor:
    return ranks(ref, inst[1], dtype=torch.float32, store=torch.bfloat16)


def compare(got: torch.Tensor, want: torch.Tensor) -> dict[str, float]:
    rel = (got.to(want.device, torch.float64) - want).abs() / want
    return {"pagerank_max_rel_err": float(rel.max())}


def work_edges(g: GraphSizes, inst, want) -> float:
    """Every iteration pulls along every edge."""
    return float(inst[1] * g.num_edges)


def needed_bytes(g: GraphSizes, items) -> dict[str, float]:
    """Bytes one round's PageRank queries need from memory, each read once
    and each written once: per iteration, the in-edge structure (int32
    sources and V + 1 offsets) and the out-degrees once, however many
    queries share that iteration (a fused pass may serve them all); per
    query and iteration, its ranks read and its new ranks written."""
    v, e = g.num_vertices, g.num_edges
    iters = max((inst[1] for inst, _ in items), default=0)
    shared = iters * (4 * e + 4 * (v + 1) + 4 * v)
    own = sum(inst[1] * 8 * v for inst, _ in items)
    return {"spmv": float(shared + own)}
