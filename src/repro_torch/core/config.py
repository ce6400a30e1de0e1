"""EngineConfig: the consolidated per-run configuration of ``run_sessions``.

Every engine feature used to land as another keyword on
``MultiQueryEngine.run_sessions`` — ``steal=``, ``governor=``, ``fuse=``,
``fusion=``, ``width_feedback=`` — and the execution-backend seam would have
made it six. This dataclass is the redesigned surface: one frozen value
object describing *how* a run executes, passed as
``run_sessions(make_executor, sessions=..., queries_per_session=...,
config=EngineConfig(...))``. The legacy keyword shim had its one-release
grace period and is gone: ``run_sessions`` now accepts ``config``
only.

Every field keeps its former default, so ``EngineConfig()`` is exactly the
former bare call: no stealing, no governor, no fusion, engine-default width
feedback, engine-default (modeled) backend, one locality domain.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Callable, Sequence

if TYPE_CHECKING:  # pragma: no cover - annotation-only imports (no cycles)
    from .backends import ExecutionBackend
    from .fusion import FusionConfig
    from .governor import CapacityGovernor
    from .session import IngestStream, PoissonArrivals


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """How one ``run_sessions`` call executes.

    Workload shape (``priorities``, ``arrivals``) and engine features
    (``steal``, ``governor``, ``fuse``/``fusion``, ``width_feedback``,
    ``backend``) in one value object; ``None``/``False`` everywhere
    reproduces the bare engine bit for bit.

    * ``priorities`` — per-session priority levels: a sequence (one entry
      per session) or a callable ``sid -> priority``; ``None`` → all 0.
    * ``arrivals`` — session arrival times: a ``PoissonArrivals`` stream, an
      explicit per-session sequence of modeled ns, or ``None`` → all at t=0.
    * ``steal`` — publish parallel runs for work-stealing and let drained
      sessions execute victims' trailing packages.
    * ``governor`` — a ``CapacityGovernor`` for elastic pool capacity and
      priority preemption; ``None`` → zero governor calls.
    * ``fuse`` / ``fusion`` — gang fusion of same-graph sessions; an
      explicit ``FusionConfig`` implies ``fuse`` regardless of the flag.
    * ``width_feedback`` — per-run override of the engine's width-keyed
      feedback switch (``None`` → the engine constructor's setting).
    * ``backend`` — per-run override of the execution substrate: an
      ``ExecutionBackend`` instance or a name (``"modeled"`` | ``"inline"``
      | ``"cuda"``); ``None`` → the engine's installed backend.
    * ``domains`` — locality domains the pool splits into (NUMA sockets,
      TPU slices). ``1`` (the default) is byte-identical to the pre-domain
      engine: no partition is built, no domain key flows anywhere.
    * ``placement`` — how sessions map to domains when ``domains > 1``:
      ``"locality"`` places each session on the domain its frontier's degree
      mass touches most (re-evaluated every iteration from the same sampled
      stats that drive packaging); ``"round_robin"`` ignores the graph
      (``sid % domains``) — the locality-blind control fig19 compares
      against.
    * ``migration_penalty`` — whether off-home execution and cross-domain
      steals pay the contention model's remote factor + migration cost
      (``c_remote_factor`` / ``c_migration_ns``); only meaningful with
      ``domains > 1``.
    * ``hetero_fuse`` — heterogeneous scan-sharing fusion: the fusion
      rendezvous key drops the algorithm, so sessions of *different*
      algorithms on the same ``(graph, domain)`` merge into one scan-shared
      gang (one topology traversal per fused step, N compute bodies, the
      shared edge-scan cost charged once). Implies ``fuse``. Default off —
      homogeneous-only fusion stays byte-identical.
    * ``adaptive_admission`` — derive the admission controller's
      ``target_share`` from the width table's measured efficiency frontier
      instead of the static worker-count heuristic (admit more sessions when
      wide execution measures poorly anyway). Requires width feedback to be
      active; a cold table is byte-identical to the static heuristic.
    * ``recalibrate`` — censor-triggered hardware recalibration: when the
      width table's censoring gate trips (the modeled clock is so far off
      the executing host that ratios clip en masse), refit the
      ``HardwareModel`` from the accumulated (modeled, measured) pairs via
      ``calibrate_from_runs`` and reset the width state, instead of just
      neutralizing the table. When the engine was constructed with a
      ``CalibrationStore`` (``MultiQueryEngine(hw, calibration=...)``), the
      refit trains on the union of this run's pairs and the store's
      persisted provenance, and is written back so later engines on the
      same (host, backend, preset) start calibrated.
    * ``dynamic`` — dynamic-graph mode: the run may carry a live ingest
      writer (``ingest``), query records stamp the epoch of the snapshot
      they pinned, and the shared prep cache's staleness stamp gains the
      snapshot epoch. ``False`` (the default) performs zero epoch calls
      and keeps every scheduling decision byte-identical to the
      static-graph engine (all committed fig10–21 modeled rows are
      unchanged).
    * ``ingest`` — the live ingest writer: an ``IngestStream`` describing
      a ``GraphEpochLog`` plus timed edge batches. The DES loop applies
      each batch between events (``EV_INGEST``) and publishes a new
      immutable snapshot; sessions already running keep the snapshot they
      started on ("readers pin, writers publish"). Requires ``dynamic``.
    """

    priorities: Sequence[int] | Callable[[int], int] | None = None
    arrivals: "PoissonArrivals | Sequence[float] | None" = None
    steal: bool = False
    governor: "CapacityGovernor | None" = None
    fuse: bool = False
    fusion: "FusionConfig | None" = None
    width_feedback: bool | None = None
    backend: "ExecutionBackend | str | None" = None
    domains: int = 1
    placement: str = "locality"
    migration_penalty: bool = True
    hetero_fuse: bool = False
    adaptive_admission: bool = False
    recalibrate: bool = False
    dynamic: bool = False
    ingest: "IngestStream | None" = None

    def __post_init__(self) -> None:
        if self.domains < 1:
            raise ValueError("domains must be >= 1")
        if self.ingest is not None and not self.dynamic:
            raise ValueError("ingest requires dynamic=True")
        if self.placement not in ("locality", "round_robin"):
            raise ValueError(
                f"placement must be 'locality' or 'round_robin', got {self.placement!r}"
            )
