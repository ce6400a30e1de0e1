"""Traversal behaviour estimators (paper §3.1, Equations 1–6).

Two quantities are predicted per iteration j of a traversal:

  |U_j| — vertices *touched* via edge traversal (Eq. 1–3): drives the shared
          memory footprint M (visited filters, rank partials).
  |F_j| — vertices *newly found* (Eq. 4–6): drives the next iteration's work.

Model assumptions (paper): uniform visit probability, no multigraph, no
rich-club correlation. p_v_visits = deg+(v) / |V_reach|.

Three fidelity tiers, selected exactly as in the paper:
  * closed-form mean-degree approximation (Eq. 3 / Eq. 6) when
    deg_max/deg_mean <= ratio threshold (1.1, §4.1.2);
  * sampled product form (Eq. 2 / Eq. 5) over up to the first
    ``sample_cap`` frontier vertices (8192 in §3.1, 4000 in §4.1.2 —
    both exposed), extrapolated to the full frontier;
  * exact product form (for tests/small frontiers).

All functions are pure and differentiable-friendly (jnp), so they can run
inside jitted drivers; numpy inputs also work for host-side scheduling.
"""
from __future__ import annotations

import math
from typing import Union

import numpy as np

Array = Union[np.ndarray, "object"]

# §4.1.2: threshold on deg_max/deg_mean for using global closed forms.
DEGREE_VARIANCE_THRESHOLD = 1.1
# §3.1: sample size for the product-form extrapolation.
SAMPLE_CAP_PREPARE = 8192
# §4.1.2: per-iteration statistics sample size.
SAMPLE_CAP_RUNTIME = 4000


def _as_float(x):
    return float(x) if np.isscalar(x) or isinstance(x, (int, float)) else x


def estimate_touched_closed_form(frontier_size, deg_mean, v_reach) -> float:
    """Eq. (3): |U_j| ≈ (1 − (1 − mean_deg/|V_reach|)^{|S_j|}) · |V_reach|."""
    v_reach = max(float(v_reach), 1.0)
    p = min(max(float(deg_mean) / v_reach, 0.0), 1.0)
    s = float(frontier_size)
    # log-space for numerical stability with large |S_j|
    if p >= 1.0:
        survive = 0.0
    else:
        survive = math.exp(s * math.log1p(-p))
    return (1.0 - survive) * v_reach


def estimate_found_closed_form(frontier_size, deg_mean, v_reach, unvisited) -> float:
    """Eq. (6): |F_j| ≈ (1 − (|V_novisit|/|V_reach|)·(1−mean/|V_reach|)^{|S_j|})·|V_reach|
    ... interpreted as expected newly-visited vertices.

    Note the paper's Eq. (4)–(6) as printed over-count (they approach
    |V_reach| as |S_j| → ∞ even when few vertices remain unvisited). We keep
    the printed form available (``paper_form=True``) and default to the
    consistent form
        |F_j| = |V_novisit| · (1 − (1 − mean/|V_reach|)^{|S_j|})
    which equals the printed form minus the constant visited mass, matches
    Eq. (4)'s derivation, and is what the product form (Eq. 5) extrapolates.
    """
    v_reach = max(float(v_reach), 1.0)
    unvisited = min(max(float(unvisited), 0.0), v_reach)
    p = min(max(float(deg_mean) / v_reach, 0.0), 1.0)
    s = float(frontier_size)
    survive = math.exp(s * math.log1p(-p)) if p < 1.0 else 0.0
    return unvisited * (1.0 - survive)


def estimate_found_paper_form(frontier_size, deg_mean, v_reach, unvisited) -> float:
    """Verbatim Eq. (6) as printed in the paper (kept for fidelity checks)."""
    v_reach = max(float(v_reach), 1.0)
    unvisited = min(max(float(unvisited), 0.0), v_reach)
    p = min(max(float(deg_mean) / v_reach, 0.0), 1.0)
    s = float(frontier_size)
    survive = math.exp(s * math.log1p(-p)) if p < 1.0 else 0.0
    return (1.0 - (unvisited / v_reach) * survive) * v_reach


def _log_survival_from_sample(degrees_sample: np.ndarray, frontier_size: int, v_reach: float) -> float:
    """log ∏_{v∈S_j} (1 − deg+(v)/|V_reach|), extrapolated from a sample.

    Eq. (2)/(5): per-vertex probabilities from *real* degrees of a frontier
    sample, extrapolated multiplicatively to the full frontier size.
    """
    degrees_sample = np.asarray(degrees_sample, dtype=np.float64)
    n = degrees_sample.size
    if n == 0 or frontier_size == 0:
        return 0.0
    p = np.clip(degrees_sample / max(v_reach, 1.0), 0.0, 1.0 - 1e-12)
    mean_log = float(np.log1p(-p).mean())
    return mean_log * float(frontier_size)


def estimate_touched_sampled(degrees_sample, frontier_size, v_reach) -> float:
    """Eq. (2) with sample extrapolation: |U_j| estimate from real degrees."""
    v_reach = max(float(v_reach), 1.0)
    log_surv = _log_survival_from_sample(degrees_sample, frontier_size, v_reach)
    return (1.0 - math.exp(log_surv)) * v_reach


def estimate_found_sampled(degrees_sample, frontier_size, v_reach, unvisited) -> float:
    """Eq. (5) with sample extrapolation (consistent form, cf. above)."""
    v_reach = max(float(v_reach), 1.0)
    unvisited = min(max(float(unvisited), 0.0), v_reach)
    log_surv = _log_survival_from_sample(degrees_sample, frontier_size, v_reach)
    return unvisited * (1.0 - math.exp(log_surv))


def estimate_touched_exact(degrees, v_reach) -> float:
    """Eq. (2) without sampling (all frontier degrees known)."""
    degrees = np.asarray(degrees, dtype=np.float64)
    return estimate_touched_sampled(degrees, degrees.size, v_reach)


class TraversalEstimator:
    """Paper-faithful estimator facade.

    Chooses closed form vs sampled product form by the degree-variance ratio
    (threshold 1.1, §4.1.2) and caps the sample at the first ``sample_cap``
    frontier vertices ("essentially up to the first 8192 vertices", §3.1).
    """

    def __init__(
        self,
        deg_mean: float,
        deg_max: float,
        v_reach: int,
        *,
        ratio_threshold: float = DEGREE_VARIANCE_THRESHOLD,
        sample_cap: int = SAMPLE_CAP_PREPARE,
    ):
        self.deg_mean = float(deg_mean)
        self.deg_max = float(deg_max)
        self.v_reach = max(int(v_reach), 1)
        self.ratio_threshold = ratio_threshold
        self.sample_cap = sample_cap

    @property
    def low_variance(self) -> bool:
        """§4.1.2 regime test: max/mean degree within the closed-form bound."""
        if self.deg_mean <= 0:
            return True
        return (self.deg_max / self.deg_mean) <= self.ratio_threshold

    def touched(self, frontier_size: int, frontier_degrees=None) -> float:
        """|U_j| estimate for a frontier of the given size."""
        if self.low_variance or frontier_degrees is None:
            return estimate_touched_closed_form(frontier_size, self.deg_mean, self.v_reach)
        sample = np.asarray(frontier_degrees)[: self.sample_cap]
        return estimate_touched_sampled(sample, frontier_size, self.v_reach)

    def found(self, frontier_size: int, unvisited: float, frontier_degrees=None) -> float:
        """|F_j| estimate."""
        if self.low_variance or frontier_degrees is None:
            return estimate_found_closed_form(
                frontier_size, self.deg_mean, self.v_reach, unvisited
            )
        sample = np.asarray(frontier_degrees)[: self.sample_cap]
        return estimate_found_sampled(sample, frontier_size, self.v_reach, unvisited)
