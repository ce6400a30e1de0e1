"""Preparation component ("Cost and Parameter Estimation", Fig. 1–3).

Wires the pieces of §3 together for one upcoming iteration:

  graph/frontier statistics  ──► traversal estimators (|U_j|, |F_j|)
            │                              │
            ▼                              ▼
  footprint model M  ──►  cache level  ──► L_mem / L_atomic(T)
                                           │
                                           ▼
                 thread bounds (Alg. 1) ──► work packages (§4.2)

Topology-centric algorithms (PR) prepare once; data-driven ones (BFS) prepare
per iteration (§4.5).

With a :class:`~.feedback.CostFeedback` passed as ``feedback``, the thread
bound sweep consults the width-keyed correction table (§4.4 feedback loop):
each candidate width's modeled cost is scaled by the *measured* width ratio,
so a victim whose packages keep being executed at thief-gang / fused-gang /
post-preemption widths plans its next iteration for the widths those paths
actually deliver instead of the widths its own solo grant would have used.
``feedback=None`` (the default) keeps preparation byte-identical.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

import numpy as np

from ..graph.structure import GraphStats
from .bounds import ThreadBounds, thread_bounds
from .contention import HardwareModel
from .cost_model import IterationWork, touched_memory_bytes
from .descriptors import AlgorithmDescriptor
from .estimators import SAMPLE_CAP_RUNTIME, TraversalEstimator
from .packaging import WorkPackages, make_packages

if TYPE_CHECKING:  # pragma: no cover - annotation-only import
    from .feedback import CostFeedback


@dataclasses.dataclass(frozen=True)
class PreparedIteration:
    """Everything the scheduler needs for one iteration: the work profile,
    the thread bounds, the generated packages — and, on a multi-domain
    engine, the frontier's per-domain degree mass (the placement signal,
    computed from the same sampled statistics that drove packaging).
    ``domain_mass is None`` on single-domain runs: no placement exists."""

    work: IterationWork
    bounds: ThreadBounds
    packages: WorkPackages
    used_local_stats: bool
    domain_mass: np.ndarray | None = None

    @property
    def home_domain(self) -> int | None:
        """The domain this iteration's degree mass touches most (argmax of
        ``domain_mass``; ties break to the lowest index), or ``None``."""
        if self.domain_mass is None or self.domain_mass.size == 0:
            return None
        return int(np.argmax(self.domain_mass))


def prepare_iteration(
    desc: AlgorithmDescriptor,
    hw: HardwareModel,
    stats: GraphStats,
    frontier_size: int,
    *,
    frontier_degrees: np.ndarray | None = None,
    unvisited: float | None = None,
    p: int | None = None,
    feedback: "CostFeedback | None" = None,
    partition=None,
    frontier_vertices: np.ndarray | None = None,
) -> PreparedIteration:
    """Run the full preparation step for the next iteration.

    ``feedback`` (optional) supplies measured (algorithm, width) corrections:
    the thread-bound sweep scores each candidate width with
    ``feedback.width_ratio`` so the plan reflects how widths actually
    performed, not just the contention model's prediction.

    ``partition`` (optional, a :class:`~..graph.partition.GraphPartition`)
    turns preparation into the placement decision point: the frontier's
    per-domain degree mass is computed here — from ``frontier_vertices``
    weighted by ``frontier_degrees`` when the executor exposes them (the
    data-driven case; the same sample cap as the local statistics applies),
    or the partition's static degree mass for whole-graph frontiers — and
    carried on the returned plan, so the engine re-evaluates a session's
    domain exactly when the frontier drifts. ``partition=None`` keeps
    preparation byte-identical."""
    est = TraversalEstimator(
        deg_mean=stats.deg_out_mean,
        deg_max=stats.deg_out_max,
        v_reach=stats.v_reach,
    )
    variance_ratio = stats.degree_variance_ratio
    use_local = (not est.low_variance) and frontier_degrees is not None
    if use_local:
        # §4.1.2: high variance → compute local statistics on a subset (up to
        # the first 4000 vertices) using real degrees, extrapolate globally.
        sample = np.asarray(frontier_degrees)[:SAMPLE_CAP_RUNTIME]
        mean_local = float(sample.mean()) if sample.size else stats.deg_out_mean
        edges = mean_local * frontier_size
        touched = est.touched(frontier_size, frontier_degrees=sample)
        found = est.found(
            frontier_size,
            unvisited if unvisited is not None else stats.v_reach,
            frontier_degrees=sample,
        )
    else:
        edges = stats.deg_out_mean * frontier_size
        touched = est.touched(frontier_size)
        found = est.found(
            frontier_size, unvisited if unvisited is not None else stats.v_reach
        )

    if desc.kind == "topology":
        # PR-style: every vertex processed, every edge traversed, no "found".
        edges = float(stats.num_edges) if frontier_size >= stats.num_vertices else edges
        found = 0.0
        touched = float(min(touched, stats.v_reach))

    m_bytes = touched_memory_bytes(desc, touched, frontier_size)
    work = IterationWork(
        frontier=float(frontier_size),
        edges=float(edges),
        found=float(found),
        touched=float(touched),
        m_bytes=float(m_bytes),
    )
    width_correction = None
    if feedback is not None:
        width_correction = lambda t: feedback.width_ratio(desc.name, t)  # noqa: E731
    tb = thread_bounds(desc, hw, work, p=p, width_correction=width_correction)
    pkgs = make_packages(
        frontier_degrees,
        tb,
        variance_ratio=variance_ratio,
        frontier_size=int(frontier_size),
    )
    domain_mass = None
    if partition is not None:
        if frontier_vertices is not None:
            verts = np.asarray(frontier_vertices)[:SAMPLE_CAP_RUNTIME]
            degs = (
                np.asarray(frontier_degrees)[:SAMPLE_CAP_RUNTIME]
                if frontier_degrees is not None
                else None
            )
            domain_mass = partition.domain_mass(verts, degs)
        else:
            domain_mass = partition.domain_mass()
    return PreparedIteration(
        work=work,
        bounds=tb,
        packages=pkgs,
        used_local_stats=use_local,
        domain_mass=domain_mass,
    )
