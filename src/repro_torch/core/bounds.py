"""Work-package and thread-boundary estimation (paper §3.3, Eq. 9–10,
Algorithm 1).

Algorithm 1 sweeps T over powers of two up to P. For each T it computes
  J_max — the largest usable parallelism given the minimum-work-per-thread
          constraint (you cannot feed more threads than total work / C_T_min),
  J_min — the smallest parallelism at which parallel beats sequential
          (Eq. 10 rearranged),
and T is *valid* iff J_max ≥ J_min with T inside [J_min, J_max]. The first
valid T becomes T_min; T_max tracks the last valid T; the sweep breaks at the
first invalid T after a valid range was found (the printed pseudo-code is
partially garbled — this reconstruction preserves its doubling loop,
min/max-set/break structure and both side conditions).

On the TPU adaptation, T is the device-group size (power-of-two sub-mesh) and
P the pod's device count.

``thread_bounds`` optionally takes a ``width_correction`` callable — a
per-width multiplicative factor on the modeled per-vertex cost, fed from the
§4.4 feedback loop's width-keyed table
(:meth:`~.feedback.CostFeedback.width_ratio`). Every cost comparison in the
sweep (Eq. 9 threshold, Eq. 10 profitability, the min-work-per-thread feed
check) then uses *measured-width-corrected* costs, so preparation plans for
the widths thieves, fused gangs and post-preemption resumes actually
deliver. ``None`` (the default) keeps the sweep byte-identical to the
uncorrected Algorithm 1.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

from .contention import HardwareModel
from .cost_model import IterationWork, c_vertex_total
from .descriptors import AlgorithmDescriptor


@dataclasses.dataclass(frozen=True)
class ThreadBounds:
    """Output of the preparation step (latency-aware parallelization)."""

    t_min: int               # minimum profitable parallelism (0 → never)
    t_max: int               # maximum profitable parallelism (0 → never)
    n_packages: int          # number of work packages to generate
    v_min_parallel: float    # Eq. 9 threshold on |V|
    parallel: bool           # final verdict: parallel execution profitable?
    cost_seq_ns: float       # predicted sequential iteration time
    cost_par_ns: float       # predicted parallel iteration time at t_max

    def clamp(self, p: int) -> "ThreadBounds":
        """Elastic re-bound: restrict to a smaller machine (node loss)."""
        if not self.parallel or p >= self.t_max:
            return self
        t_max = 1 << int(math.floor(math.log2(max(p, 1))))
        if t_max < self.t_min:
            return dataclasses.replace(
                self, parallel=False, t_min=0, t_max=0, n_packages=1
            )
        return dataclasses.replace(self, t_max=t_max)


def v_min_for_parallel(desc: AlgorithmDescriptor, hw: HardwareModel, work: IterationWork) -> float:
    """Eq. (9): minimum frontier size for parallel execution to be considered."""
    c_v = c_vertex_total(desc, hw, work, t=1)
    if c_v <= 0:
        return math.inf
    return (hw.c_t_min_work_ns + hw.c_para_startup_ns) / c_v


def parallel_beats_sequential(
    desc: AlgorithmDescriptor,
    hw: HardwareModel,
    work: IterationWork,
    t: int,
) -> bool:
    """Eq. (10): C_v,seq > C_v,para(T)/T + C_T_overhead·T/|V|."""
    v = max(work.frontier, 1.0)
    c_seq = c_vertex_total(desc, hw, work, t=1)
    c_par = c_vertex_total(desc, hw, work, t=t)
    return c_seq > c_par / t + hw.c_thread_overhead_ns * t / v


def thread_bounds(
    desc: AlgorithmDescriptor,
    hw: HardwareModel,
    work: IterationWork,
    p: int | None = None,
    *,
    width_correction: Callable[[int], float] | None = None,
) -> ThreadBounds:
    """Algorithm 1 — compute [T_min, T_max] and the package count.

    ``width_correction(t)`` (optional) scales the modeled per-vertex cost at
    width ``t`` by a measured factor from the feedback table's width-keyed
    corrections; ``None`` reproduces the uncorrected sweep exactly."""
    p = int(p or hw.max_threads)
    v = max(work.frontier, 1.0)
    if width_correction is None:
        c_seq = c_vertex_total(desc, hw, work, t=1)
        v_min = v_min_for_parallel(desc, hw, work)
    else:
        c_seq = c_vertex_total(desc, hw, work, t=1) * width_correction(1)
        # Eq. 9 with the corrected sequential cost (same rearrangement)
        v_min = (
            (hw.c_t_min_work_ns + hw.c_para_startup_ns) / c_seq
            if c_seq > 0
            else math.inf
        )
    total_seq_ns = v * c_seq

    t_min, t_max = 0, 0
    min_not_set = True
    if v >= v_min:
        t = 1
        while t <= p:
            if t > 1:
                c_par = c_vertex_total(desc, hw, work, t=t)
                if width_correction is not None:
                    c_par *= width_correction(t)
                # J_max: parallelism the work can feed (min-work-per-thread)
                j_max = max(t, int(v * c_par // max(hw.c_t_min_work_ns, 1.0)))
                feeds = (v * c_par) >= (t * hw.c_t_min_work_ns)
                # Eq. 10 over the (possibly width-corrected) costs; with no
                # correction this is exactly parallel_beats_sequential
                profitable = c_seq > c_par / t + hw.c_thread_overhead_ns * t / v
                valid = feeds and profitable and j_max >= t
                if valid:
                    t_max = t
                    if min_not_set:
                        t_min = t
                        min_not_set = False
                elif not min_not_set:
                    break  # left the contiguous valid range
            t <<= 1

    parallel = t_max >= 2
    if parallel:
        c_par_max = c_vertex_total(desc, hw, work, t=t_max)
        if width_correction is not None:
            c_par_max *= width_correction(t_max)
        c_par_ns = (
            v * c_par_max / t_max
            + hw.c_thread_overhead_ns * t_max
            + hw.c_para_startup_ns
        )
        # §4.2: package count capped at 8 × usable parallelism, but each
        # package must carry at least C_T_min work.
        by_work = int(total_seq_ns // max(hw.c_t_min_work_ns, 1.0))
        n_packages = max(min(hw.max_packages_factor * t_max, max(by_work, 1)), t_max)
    else:
        c_par_ns = total_seq_ns
        n_packages = 1

    return ThreadBounds(
        t_min=t_min if parallel else 0,
        t_max=t_max if parallel else 0,
        n_packages=n_packages,
        v_min_parallel=v_min,
        parallel=parallel,
        cost_seq_ns=total_seq_ns,
        cost_par_ns=c_par_ns,
    )
