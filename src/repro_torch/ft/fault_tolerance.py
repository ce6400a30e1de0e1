"""Fault tolerance: heartbeats, straggler mitigation, elastic re-planning.

The port of ``repro/ft/fault_tolerance.py``, name for name, with the same
arguments, defaults and injectable ``clock``. It needs no device: numpy,
``core.bounds.ThreadBounds`` and ``core.scheduler.WorkerPool``.

The paper's own machinery is the elasticity policy. Node loss shrinks P;
re-running Algorithm 1 with the surviving worker count yields new
[T_min, T_max] bounds, and the 8x work-package overdecomposition (§4.2) is
the work-stealing grain that lets surviving workers absorb a failed
worker's packages.

  * HeartbeatMonitor — liveness per worker group; a group is dead after
    ``timeout_s`` without a beat, and its beats are ignored until it
    rejoins.
  * StragglerPolicy — per-package latencies; an unfinished package running
    longer than ``slow_factor`` × the median of the finished ones is
    reissued (a backup task; a duplicate completion is idempotent, since a
    package is a pure function of its state).
  * ElasticPlan — a capacity change resizes the ``WorkerPool``, clamps every
    in-flight query's ``ThreadBounds`` and, for data-parallel jobs,
    re-strides the batch over the survivors.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from ..core.bounds import ThreadBounds
from ..core.scheduler import WorkerPool


class HeartbeatMonitor:
    def __init__(self, groups: list[str], *, timeout_s: float = 10.0, clock=time.monotonic):
        self._clock = clock
        self.timeout_s = timeout_s
        now = clock()
        self._last = {g: now for g in groups}
        self._dead: set[str] = set()

    def beat(self, group: str) -> None:
        if group in self._dead:
            return  # a dead group comes back only through rejoin()
        self._last[group] = self._clock()

    def rejoin(self, group: str) -> None:
        self._dead.discard(group)
        self._last[group] = self._clock()

    def check(self) -> list[str]:
        """Returns the groups that died since the last check."""
        now = self._clock()
        newly = [g for g, t in self._last.items() if g not in self._dead and now - t > self.timeout_s]
        self._dead.update(newly)
        return newly

    @property
    def alive(self) -> list[str]:
        return [g for g in self._last if g not in self._dead]


@dataclasses.dataclass
class PackageTiming:
    package: int
    started: float
    finished: float | None = None


class StragglerPolicy:
    """Backup-task reissue for tail packages (the 8x overdecomposition grain)."""

    def __init__(self, *, slow_factor: float = 3.0, min_samples: int = 4, clock=time.monotonic):
        self.slow_factor = slow_factor
        self.min_samples = min_samples
        self._clock = clock
        self._timings: dict[int, PackageTiming] = {}

    def started(self, package: int) -> None:
        self._timings[package] = PackageTiming(package, self._clock())

    def finished(self, package: int) -> None:
        t = self._timings.get(package)
        if t and t.finished is None:
            t.finished = self._clock()

    def to_reissue(self) -> list[int]:
        done = [t.finished - t.started for t in self._timings.values() if t.finished]
        if len(done) < self.min_samples:
            return []
        median = float(np.median(done))
        now = self._clock()
        return [
            t.package
            for t in self._timings.values()
            if t.finished is None and now - t.started > self.slow_factor * max(median, 1e-9)
        ]


class ElasticPlan:
    """Capacity-change reaction: pool resize, bounds clamp, restride."""

    def __init__(self, pool: WorkerPool):
        self.pool = pool
        self.events: list[tuple[str, int]] = []

    def on_capacity_change(self, new_capacity: int, bounds_in_flight: list[ThreadBounds]) -> list[ThreadBounds]:
        old = self.pool.capacity
        self.pool.resize(new_capacity)
        self.events.append(("shrink" if new_capacity < old else "grow", new_capacity))
        return [b.clamp(new_capacity) for b in bounds_in_flight]

    @staticmethod
    def reshard_batch(global_batch: int, survivors: int) -> list[tuple[int, int]]:
        """Re-stride a data-parallel batch over the surviving workers."""
        bounds = np.linspace(0, global_batch, survivors + 1).round().astype(int)
        return [(int(a), int(b)) for a, b in zip(bounds[:-1], bounds[1:])]
