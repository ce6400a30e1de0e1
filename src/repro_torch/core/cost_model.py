"""Cost model (paper §3.2, Equations 7–8).

    C_sub(i, T, M) = N_ops(i)·L_op + N_atomics(i)·L_atomic(T, M)
                   + N_mem(i)·L_mem(M)                                (Eq. 7)

    C_total(T, M)  = C_sub(v) + |E_j|/|S_j|·C_sub(e) + |F_j|/|S_j|·C_sub(f)
                                                                      (Eq. 8)

Fundamental assumption carried over from the paper: the sequential and
parallel implementations are identical except that the parallel one guards
critical sections with atomics, modelled by L_atomic(T=1, M) == L_mem(M).
On TPU, "sequential" is the single-device program (no collectives) and
"parallel" the T-device shard_map (with combine collectives) — same identity.
"""
from __future__ import annotations

import dataclasses

from .contention import HardwareModel
from .descriptors import AlgorithmDescriptor, ItemCost


@dataclasses.dataclass(frozen=True)
class IterationWork:
    """Work profile of one iteration, filled from stats + estimators.

    frontier:     |S_j|
    edges:        |E_j| (sum of frontier out-degrees)
    found:        |F_j| estimate
    touched:      |U_j| estimate
    m_bytes:      touched shared memory M (linear model over |U_j|, §4.1.1)
    """

    frontier: float
    edges: float
    found: float
    touched: float
    m_bytes: float


def touched_memory_bytes(desc: AlgorithmDescriptor, touched: float, frontier: float) -> float:
    """Linear footprint model (§4.1.1): M = |U_j|·bytes_touched + |S_j|·private."""
    return (
        touched * desc.bytes_per_touched
        + frontier * desc.bytes_per_vertex_private
    )


def c_sub(item: ItemCost, hw: HardwareModel, t: int, m_bytes: float) -> float:
    """Eq. (7), in ns."""
    return (
        item.n_ops * hw.l_op
        + item.n_atomics * hw.l_atomic(t, m_bytes)
        + item.n_mem * hw.l_mem(m_bytes)
    )


def c_vertex_total(
    desc: AlgorithmDescriptor,
    hw: HardwareModel,
    work: IterationWork,
    t: int,
) -> float:
    """Eq. (8): per-frontier-vertex total cost at thread count T, in ns."""
    s = max(work.frontier, 1.0)
    epv = work.edges / s
    fpv = work.found / s
    return (
        c_sub(desc.v, hw, t, work.m_bytes)
        + epv * c_sub(desc.e, hw, t, work.m_bytes)
        + fpv * c_sub(desc.f, hw, t, work.m_bytes)
    )


def c_vertex_sequential(desc: AlgorithmDescriptor, hw: HardwareModel, work: IterationWork) -> float:
    """Sequential per-vertex cost: T=1, atomics degrade to plain memory ops."""
    return c_vertex_total(desc, hw, work, t=1)


def iteration_cost_ns(
    desc: AlgorithmDescriptor,
    hw: HardwareModel,
    work: IterationWork,
    t: int,
) -> float:
    """Predicted elapsed time of one iteration at thread count T (ns),
    including parallelization overheads (Eq. 10 right-hand side × |V|)."""
    cv = c_vertex_total(desc, hw, work, t)
    if t <= 1:
        return work.frontier * cv
    return (
        work.frontier * cv / t
        + hw.c_thread_overhead_ns * t
        + hw.c_para_startup_ns
    )
