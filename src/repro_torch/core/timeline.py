"""Step-function timeline math shared by the engine report and governor.

Timelines throughout the runtime are right-continuous step functions sampled
as ``[(t, value), ...]`` with nondecreasing ``t`` — pool utilization,
in-flight sessions, elastic capacity. Every time-weighted mean in
:class:`~.session.EngineReport` reduces to one integral over such a series,
so the integration (including the degenerate empty / zero-span cases) lives
here exactly once.
"""
from __future__ import annotations

from typing import Sequence


def step_integral(
    samples: Sequence[tuple[float, float]], t_lo: float, t_hi: float
) -> float:
    """``∫ value(t) dt`` over ``[t_lo, t_hi]`` for a right-continuous step
    series. The first value extends backward to ``t_lo`` and the last value
    forward to ``t_hi``; empty series and non-positive spans integrate to
    0.0 (never raise)."""
    if t_hi <= t_lo or not samples:
        return 0.0
    acc = 0.0
    first_t = samples[0][0]
    if first_t > t_lo:
        acc += (min(first_t, t_hi) - t_lo) * samples[0][1]
    for i, (t, v) in enumerate(samples):
        t_next = samples[i + 1][0] if i + 1 < len(samples) else t_hi
        lo, hi = max(t, t_lo), min(t_next, t_hi)
        if hi > lo:
            acc += (hi - lo) * v
    return float(acc)


def step_mean(
    samples: Sequence[tuple[float, float]], t_lo: float, t_hi: float
) -> float:
    """Time-weighted mean of a step series over ``[t_lo, t_hi]``; for a
    zero-width span, the unweighted mean of the sampled values (the only
    sensible reading of an instantaneous timeline); 0.0 when empty."""
    if not samples:
        return 0.0
    if t_hi <= t_lo:
        return float(sum(v for _, v in samples) / len(samples))
    return step_integral(samples, t_lo, t_hi) / (t_hi - t_lo)
