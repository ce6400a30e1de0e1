"""Cost-based work packaging (paper §4.2).

Policy, verbatim from the paper:
  * high degree variance AND small frontier  → *cost-based* packages: walk the
    frontier accumulating out-degree (the vertex/edge performance model) until
    the per-package work share is exceeded; cap the package count at 8× the
    maximum usable parallelism; reorder so packages dominated by a single
    heavy vertex run first;
  * large frontier OR low variance           → *static* equal partitioning,
    still overdecomposed (packages ≫ cores) so the runtime can react to
    dynamic behaviour (this is also our straggler-mitigation grain).

Packages are (start, size) ranges over the (possibly degree-ordered) frontier
— fixed-shape tables so the device-side executors stay static.
"""
from __future__ import annotations

import dataclasses
from typing import Literal

import numpy as np

from ..graph.partition import degree_balanced_ranges, equal_ranges, heavy_first_order
from .bounds import ThreadBounds

# §4.1.2 / §4.2: variance indicator threshold on deg_max/deg_mean.
VARIANCE_RATIO_THRESHOLD = 1.1
# "low numbers of vertices" cut-off for the cost-based path (paper samples
# up to the first 4000 vertices for local statistics).
SMALL_FRONTIER_CAP = 4096


@dataclasses.dataclass(frozen=True)
class WorkPackages:
    """A partition of the frontier into executable packages.

    bounds:  [n+1] int64 — package k covers frontier slots [bounds[k], bounds[k+1])
    order:   [n]   int64 — execution order (heavy first for cost-based)
    mode:    packaging mode used
    """

    bounds: np.ndarray
    order: np.ndarray
    mode: Literal["cost_based", "static", "single"]

    @property
    def n_packages(self) -> int:
        """Number of generated work packages."""
        return len(self.bounds) - 1

    def sizes(self) -> np.ndarray:
        """Frontier slots per package (``diff`` of the bounds)."""
        return np.diff(self.bounds)

    def covers(self, n: int) -> bool:
        """True when the packages exactly tile frontier slots ``[0, n)``."""
        return int(self.bounds[0]) == 0 and int(self.bounds[-1]) == n


def make_packages(
    frontier_degrees: np.ndarray | None,
    bounds: ThreadBounds,
    *,
    variance_ratio: float,
    frontier_size: int | None = None,
    variance_threshold: float = VARIANCE_RATIO_THRESHOLD,
    small_frontier_cap: int = SMALL_FRONTIER_CAP,
) -> WorkPackages:
    """Generate work packages for one iteration (§4.2).

    ``frontier_degrees`` may be a *sample* (shorter than the frontier); the
    cost-based path requires full degrees, so a sample forces the static
    path — matching the paper, which only walks real degrees for small
    frontiers."""
    degrees = (
        np.asarray(frontier_degrees, dtype=np.int64)
        if frontier_degrees is not None
        else None
    )
    n = int(frontier_size if frontier_size is not None else (degrees.size if degrees is not None else 0))
    full_degrees = degrees is not None and degrees.size == n

    if not bounds.parallel or n == 0 or bounds.n_packages <= 1:
        return WorkPackages(
            bounds=np.array([0, n], dtype=np.int64),
            order=np.array([0], dtype=np.int64),
            mode="single",
        )

    n_packages = int(min(bounds.n_packages, max(n, 1)))
    high_variance = variance_ratio > variance_threshold
    small = n <= small_frontier_cap

    if high_variance and small and full_degrees:
        pkg_bounds = degree_balanced_ranges(degrees, n_packages)
        order = heavy_first_order(degrees, pkg_bounds)
        mode = "cost_based"
    else:
        pkg_bounds = equal_ranges(n, n_packages)
        order = np.arange(len(pkg_bounds) - 1, dtype=np.int64)
        mode = "static"

    # collapse empty packages produced by skewed prefix sums
    keep = np.diff(pkg_bounds) > 0
    if not keep.all():
        starts = pkg_bounds[:-1][keep]
        pkg_bounds = np.concatenate([starts, [pkg_bounds[-1]]])
        if mode == "cost_based":
            order = heavy_first_order(degrees, pkg_bounds)
        else:
            order = np.arange(len(pkg_bounds) - 1, dtype=np.int64)

    return WorkPackages(bounds=pkg_bounds.astype(np.int64), order=order, mode=mode)


def packages_to_table(pkgs: WorkPackages, max_packages: int) -> tuple[np.ndarray, np.ndarray]:
    """Fixed-shape (starts, sizes) table (padded with zero-size packages) for
    device-side consumption — XLA needs static shapes.

    A package list larger than the table is an error: silently truncating
    would drop frontier ranges on the device (silent work loss)."""
    if pkgs.n_packages > max_packages:
        raise ValueError(
            f"{pkgs.n_packages} packages exceed the device table "
            f"(max_packages={max_packages}); repackage with fewer packages "
            "or grow the table"
        )
    starts = np.zeros(max_packages, dtype=np.int32)
    sizes = np.zeros(max_packages, dtype=np.int32)
    n = pkgs.n_packages
    ordered = pkgs.order[:n]
    starts[:n] = pkgs.bounds[:-1][ordered]
    sizes[:n] = np.diff(pkgs.bounds)[ordered]
    return starts, sizes
