"""Multi-query engine: concurrent sessions over a shared worker pool.

Reproduces the paper's evaluation harness (§6): N concurrent sessions, each
executing a stream of graph queries; the engine's scheduler controls
intra-query parallelism per iteration while inter-query parallelism emerges
from sessions contending for the shared :class:`WorkerPool`.

Two clocks are kept:
  * *measured* — real wall time of the JAX compute on this host (single CPU
    device here; on TPU this is the real distributed execution);
  * *modeled*  — the cost model's predicted time at the granted parallelism
    under the selected hardware preset, advanced by a discrete-event
    simulation so that worker contention between sessions is honoured. The
    modeled clock is what reproduces the paper's PEPS/TEPS concurrency
    figures on hardware we don't physically have.

``run_query`` and ``run_sessions`` share one per-iteration execution path
(prepare → decide → schedule → account → feedback); the only difference is
who advances the clock. ``run_query`` drives the stepwise
:class:`~.scheduler.ScheduleRun` to completion immediately, while
``run_sessions`` interleaves the steps of many sessions on the modeled
timeline, so the §4.3 protocol — grant re-evaluation after each sequential
package, the ``seq_package_limit`` fallback, early release — runs with real
inter-session contention.

On top of the unified loop the engine provides the inter-query controls a
multi-tenant deployment needs: an :class:`AdmissionController` that caps
in-flight sessions by pool pressure, open-loop :class:`PoissonArrivals`
session streams, per-query priority levels honoured by
``WorkerPool.request``, and an :class:`EngineReport` with latency
percentiles and a pool-utilization timeline.

``run_sessions(config=EngineConfig(fuse=True))`` adds gang fusion
(``core.fusion``): sessions
running the same algorithm on the same graph rendezvous at iteration
boundaries and — when their summed ``T_max`` exceeds the pool capacity —
merge their next iterations into one fused ``ScheduleRun`` whose trace is
split back per member, so the per-session records stay exact while the gang
launch overhead is paid once instead of once per member.
"""
from __future__ import annotations

import collections
import dataclasses
import heapq
import time
from typing import TYPE_CHECKING, Any, Callable, Protocol, Sequence

import numpy as np

from . import tracing
from .autotuner import PreparedIteration, prepare_iteration
from .backends import ExecutionBackend, resolve_backend
from .bounds import ThreadBounds
from .calibration import CalibrationStore
from .config import EngineConfig
from .feedback import CostFeedback
from .contention import HardwareModel, cross_domain_cost_ns, recalibrate_preset
from .cost_model import iteration_cost_ns
from .descriptors import AlgorithmDescriptor
from .fusion import (
    FusionConfig,
    FusionGroup,
    FusionMember,
    apply_scan_sharing,
    gang_overhead_ns,
    member_scan_ns,
    member_work_ns,
    merge_member_trace,
    plan_gang_width,
    plan_hetero_gang_width,
    should_fuse,
)
from .packaging import WorkPackages
from .scheduler import (
    PackageScheduler,
    ScheduleRun,
    ScheduleStep,
    ScheduleTrace,
    WorkerPool,
    largest_pow2_leq,
)
from .stealing import StealRegistry, graph_identity
from .timeline import step_integral, step_mean
from ..graph.partition import GraphPartition

if TYPE_CHECKING:  # pragma: no cover - annotation-only import (no cycle)
    from .governor import CapacityGovernor

# packages a thief claims per granted worker in one steal chunk; small enough
# that the victim's own grant re-evaluation keeps mattering, large enough to
# amortize the claim
STEAL_CHUNK = 4


class QueryExecutor(Protocol):
    """One in-flight query. Implemented by repro_torch.algorithms.*."""

    desc: AlgorithmDescriptor

    def start(self) -> None:
        """Reset executor state for a fresh run of the query."""
        ...

    def finished(self) -> bool:
        """True when the query has converged / exhausted its iterations."""
        ...

    def graph_stats(self) -> Any:
        """The ``GraphStats`` of the traversed graph (preparation input)."""
        ...
    def frontier(self) -> tuple[int, np.ndarray | None, float]:
        """(frontier_size, frontier_degrees|None, unvisited_estimate)"""
        ...
    def run_packages(self, package_ids: np.ndarray, packages: WorkPackages, t: int, parallel: bool) -> None:
        """Execute the given packages at width ``t`` (the real compute)."""
        ...

    def edges_traversed(self) -> float:
        """Edges processed so far (the PEPS/TEPS numerator)."""
        ...

    def result(self) -> Any:
        """The query's answer (ranks, BFS tree, ...) for verification."""
        ...


@dataclasses.dataclass
class QueryRecord:
    """Per-query ground truth: modeled/measured time, edges, latencies, and
    the full decision traces — kept exact across stealing, fusion split-back
    and preemption (the engine books every package back to its owner)."""

    session: int
    query: int
    algorithm: str
    priority: int = 0
    iterations: int = 0
    parallel_iterations: int = 0
    edges: float = 0.0
    modeled_ns: float = 0.0
    measured_ns: float = 0.0
    submitted_ns: float = 0.0     # modeled clock: query entered the system
    started_ns: float = 0.0       # modeled clock: first iteration began
    finished_ns: float = 0.0      # modeled clock: query completed
    # host wall clock (perf_counter_ns) of run_sessions: the engine began
    # making the query's executor, and the engine saw the query done
    submitted_wall_ns: int = 0
    finished_wall_ns: int = 0
    # packages of this query executed by thief sessions (work-stealing)
    stolen_packages: int = 0
    # packages of this query executed inside a fused same-graph gang (gang
    # fusion); the per-member split-back keeps this record's modeled time,
    # edges and traces exact even when the iteration ran co-scheduled
    fused_packages: int = 0
    # dynamic-graph runs: epoch of the snapshot this query pinned at start
    # (None on static runs — the field is only stamped under
    # ``EngineConfig(dynamic=True)``)
    graph_epoch: int | None = None
    traces: list[ScheduleTrace] = dataclasses.field(default_factory=list)

    @property
    def latency_ns(self) -> float:
        """Modeled end-to-end latency including admission wait."""
        return max(self.finished_ns - self.submitted_ns, 0.0)


def _percentiles(latencies_ns: Sequence[float]) -> dict[str, float]:
    if not latencies_ns:
        return {"p50": 0.0, "p95": 0.0, "p99": 0.0}
    arr = np.asarray(latencies_ns, dtype=np.float64)
    return {f"p{q}": float(np.percentile(arr, q)) for q in (50, 95, 99)}


@dataclasses.dataclass
class EngineReport:
    """Run-level result of ``run_sessions``: per-query records plus the
    machine timelines (utilization, capacity, in-flight, steal/fusion/
    preemption events) and the derived throughput/latency accessors."""

    records: list[QueryRecord]
    makespan_modeled_ns: float
    makespan_measured_ns: float
    pool_capacity: int
    admission_cap: int | None = None
    # (modeled time_ns, workers in use) samples, one per scheduling event
    utilization: list[tuple[float, int]] = dataclasses.field(default_factory=list)
    # (modeled time_ns, sessions in flight) samples, one per admission change
    inflight: list[tuple[float, int]] = dataclasses.field(default_factory=list)
    # (modeled time_ns, thief session, victim session, packages) per steal
    steal_events: list[tuple[float, int, int, int]] = dataclasses.field(
        default_factory=list
    )
    # (modeled time_ns, pool capacity) samples — more than one entry only
    # when a capacity governor (or a resize hook caller) was in the loop
    capacity_timeline: list[tuple[float, int]] = dataclasses.field(default_factory=list)
    # (modeled time_ns, old capacity, new capacity, reason) per governor action
    resize_events: list[tuple[float, int, int, str]] = dataclasses.field(
        default_factory=list
    )
    # (modeled time_ns, preempted session id) per governor fence
    preemptions: list[tuple[float, int]] = dataclasses.field(default_factory=list)
    # (modeled time_ns, driver id, member sessions, fused packages) per gang
    # formed by gang fusion (driver ids are negative — they are scheduling
    # entities, not sessions, and never appear in ``records``)
    fusion_events: list[tuple[float, int, int, int]] = dataclasses.field(
        default_factory=list
    )
    # locality domains the pool was split into for this run (1 → the
    # pre-domain engine: no partition built, no domain key anywhere)
    domains: int = 1
    # per-domain (modeled time_ns, workers in use) timelines — one list per
    # domain, populated only when ``domains > 1`` (the governor's per-domain
    # resize decisions read these)
    utilization_by_domain: list[list[tuple[float, int]]] = dataclasses.field(
        default_factory=list
    )
    # steals whose thief and victim sat on different locality domains (each
    # paid the cross-domain remote factor + migration cost when the run's
    # ``migration_penalty`` was on)
    cross_domain_steals: int = 0
    # dynamic-graph runs: (modeled time_ns, published epoch, batch edges)
    # per ingest-writer batch applied between DES events (empty on static
    # runs — the writer only exists under ``dynamic=True`` with an
    # ``IngestStream``)
    ingest_events: list[tuple[float, int, int]] = dataclasses.field(
        default_factory=list
    )

    @property
    def total_edges(self) -> float:
        """Edges processed across all queries (throughput numerator)."""
        return sum(r.edges for r in self.records)

    def throughput_modeled(self) -> float:
        """Aggregate processed/traversed edges per second (modeled clock)."""
        if self.makespan_modeled_ns <= 0:
            return 0.0
        return self.total_edges / (self.makespan_modeled_ns * 1e-9)

    def throughput_measured(self) -> float:
        """Aggregate edges per second of real wall time on this host."""
        if self.makespan_measured_ns <= 0:
            return 0.0
        return self.total_edges / (self.makespan_measured_ns * 1e-9)

    # -------------------------------------------------- latency + utilization
    def latency_percentiles(self) -> dict[str, float]:
        """p50/p95/p99 modeled query latency across all sessions (ns)."""
        return _percentiles([r.latency_ns for r in self.records if r.finished_ns > 0])

    def latency_percentiles_by_session(self) -> dict[int, dict[str, float]]:
        """p50/p95/p99 modeled latency per session id (ns)."""
        by_session: dict[int, list[float]] = collections.defaultdict(list)
        for r in self.records:
            if r.finished_ns > 0:
                by_session[r.session].append(r.latency_ns)
        return {sid: _percentiles(lats) for sid, lats in sorted(by_session.items())}

    def latency_percentiles_by_priority(self) -> dict[int, dict[str, float]]:
        """p50/p95/p99 modeled latency per priority class (ns) — the number
        the per-priority admission quotas and preemption exist to protect."""
        by_prio: dict[int, list[float]] = collections.defaultdict(list)
        for r in self.records:
            if r.finished_ns > 0:
                by_prio[r.priority].append(r.latency_ns)
        return {p: _percentiles(lats) for p, lats in sorted(by_prio.items())}

    def mean_utilization(self) -> float:
        """Busy worker-time over *provisioned* worker-time (modeled clock):
        ``∫ in_use dt / ∫ capacity dt`` across the utilization sample span.

        For a fixed-``P`` run this reduces exactly to the time-weighted mean
        fraction of the pool in use. Under an elastic capacity timeline the
        denominator follows the governed capacity, so shrinking an idle pool
        raises utilization and holding an over-grown pool lowers it — the
        cost-of-provisioned-hardware meaning the governor optimizes for.
        Empty or zero-duration timelines yield 0.0 rather than raising."""
        if len(self.utilization) < 2:
            return 0.0
        t_lo, t_hi = self.utilization[0][0], self.utilization[-1][0]
        capline = self.capacity_timeline or [(t_lo, self.pool_capacity)]
        if t_hi <= t_lo:
            cap = capline[-1][1]
            if cap <= 0:
                return 0.0
            return step_mean(self.utilization, t_lo, t_hi) / cap
        provisioned = step_integral(capline, t_lo, t_hi)
        if provisioned <= 0:
            return 0.0
        return step_integral(self.utilization, t_lo, t_hi) / provisioned

    def mean_capacity(self) -> float:
        """Time-weighted mean pool capacity over the run (modeled clock);
        equals ``pool_capacity`` for fixed-``P`` runs."""
        line = self.capacity_timeline
        if not line:
            return float(self.pool_capacity)
        end = max(self.makespan_modeled_ns, line[-1][0])
        return step_mean(line, line[0][0], end)

    @property
    def max_inflight(self) -> int:
        """Peak number of concurrently admitted sessions."""
        return max((n for _, n in self.inflight), default=0)

    def mean_inflight(self) -> float:
        """Time-weighted mean of admitted sessions (0.0 on empty/degenerate
        timelines)."""
        if not self.inflight:
            return 0.0
        return step_mean(self.inflight, self.inflight[0][0], self.inflight[-1][0])

    # -------------------------------------------------- elastic capacity
    @property
    def grow_events(self) -> int:
        """Governor resizes that increased capacity."""
        return sum(new > old for _, old, new, _ in self.resize_events)

    @property
    def shrink_events(self) -> int:
        """Governor resizes that decreased capacity."""
        return sum(new < old for _, old, new, _ in self.resize_events)

    def resize_rate(self) -> float:
        """Governor resize actions per modeled second (0.0 for a
        zero-duration run — never a ZeroDivisionError)."""
        if self.makespan_modeled_ns <= 0:
            return 0.0
        return len(self.resize_events) / (self.makespan_modeled_ns * 1e-9)

    def preemption_rate(self) -> float:
        """Governor preemption fences per modeled second (guarded like
        :meth:`resize_rate`)."""
        if self.makespan_modeled_ns <= 0:
            return 0.0
        return len(self.preemptions) / (self.makespan_modeled_ns * 1e-9)

    # -------------------------------------------------- gang fusion
    @property
    def total_fused(self) -> int:
        """Packages executed inside fused same-graph gangs, across all
        queries (== the sum of per-record ``fused_packages`` booked at gang
        formation time; the split-back keeps the per-record counts exact)."""
        return sum(r.fused_packages for r in self.records)

    def fusion_rate(self) -> float:
        """Fused packages per modeled second across the whole run."""
        if self.makespan_modeled_ns <= 0:
            return 0.0
        return self.total_fused / (self.makespan_modeled_ns * 1e-9)

    # -------------------------------------------------- width accounting
    def width_histogram(self) -> dict[int, int]:
        """Packages executed per gang width across all queries — the sum of
        the per-trace :meth:`~.scheduler.ScheduleTrace.width_histogram`
        maps. The delivered-width distribution the §4.4 width-keyed feedback
        corrects along (fig17 reports it per variant)."""
        hist: dict[int, int] = {}
        for r in self.records:
            for trace in r.traces:
                for w, n in trace.width_histogram().items():
                    hist[w] = hist.get(w, 0) + n
        return hist

    # -------------------------------------------------- work-stealing
    @property
    def total_stolen(self) -> int:
        """Packages executed by a session other than their query's own."""
        return sum(k for _, _, _, k in self.steal_events)

    def steal_timeline(self) -> list[tuple[float, int]]:
        """Cumulative stolen packages over the modeled clock."""
        out: list[tuple[float, int]] = []
        total = 0
        for t, _, _, k in self.steal_events:
            total += k
            out.append((t, total))
        return out

    def steal_rate(self) -> float:
        """Stolen packages per modeled second across the whole run."""
        if self.makespan_modeled_ns <= 0:
            return 0.0
        return self.total_stolen / (self.makespan_modeled_ns * 1e-9)

    # -------------------------------------------------- locality domains
    def cross_domain_steal_fraction(self) -> float:
        """Share of steal events that crossed a domain boundary (0.0 on
        steal-less or single-domain runs)."""
        if not self.steal_events:
            return 0.0
        return self.cross_domain_steals / len(self.steal_events)

    def mean_utilization_by_domain(self) -> list[float]:
        """Time-weighted mean busy workers per domain (empty for D=1)."""
        out: list[float] = []
        for line in self.utilization_by_domain:
            if len(line) < 2 or line[-1][0] <= line[0][0]:
                out.append(0.0)
            else:
                out.append(step_mean(line, line[0][0], line[-1][0]))
        return out

    # -------------------------------------------------- dynamic graphs
    @property
    def epochs_published(self) -> int:
        """Snapshots the ingest writer published during the run (an empty
        batch is a no-op publish and does not advance the epoch, so this
        counts *distinct* epochs among the ingest events)."""
        return len({e for _, e, _ in self.ingest_events})

    def epoch_histogram(self) -> dict[int | None, int]:
        """Queries per pinned snapshot epoch — the reader-side evidence that
        sessions starting before/after a publish pinned different snapshots
        (``None`` buckets static-run records, which never stamp an epoch)."""
        hist: dict[int | None, int] = {}
        for r in self.records:
            hist[r.graph_epoch] = hist.get(r.graph_epoch, 0) + 1
        return hist


@dataclasses.dataclass(frozen=True)
class PoissonArrivals:
    """Open-loop session arrival stream: exponential inter-arrival times with
    a deterministic seed, so bursty-traffic benchmarks are reproducible.

    ``rate_per_s`` is on the *modeled* clock (sessions per modeled second)."""

    rate_per_s: float
    seed: int = 0

    def times_ns(self, n: int) -> np.ndarray:
        """The first ``n`` arrival timestamps (modeled ns, cumulative)."""
        if self.rate_per_s <= 0:
            raise ValueError("rate_per_s must be positive")
        rng = np.random.default_rng(self.seed)
        gaps = rng.exponential(1e9 / self.rate_per_s, size=n)
        return np.cumsum(gaps)


@dataclasses.dataclass(frozen=True)
class IngestStream:
    """The dynamic-graph writer session: timed edge batches into an epoch log.

    Passed as ``EngineConfig(dynamic=True, ingest=IngestStream(...))``, this
    drives the DES loop's ingest writer: at each batch time an ``EV_INGEST``
    event applies the batch to ``log`` and publishes a new immutable
    snapshot (``GraphEpochLog.ingest``). Like the governor heartbeat, the
    writer is a scheduling entity rather than a query — it holds no pool
    workers, takes no admission slot, and never advances the work clock
    (the modeled makespan stays reader completion), but every snapshot it
    publishes changes what *newly starting* readers see: ``make_executor``
    typically closes over ``log.current()``. Readers already running keep
    the snapshot they pinned at query start — snapshots share no mutable
    state, so the "readers pin, writers publish" invariant is structural.

    ``batches`` is a sequence of ``(src, dst)`` edge-array pairs applied in
    order; batch ``i`` lands at ``start_ns + (i + 1) * interval_ns`` on the
    modeled clock (the writer needs a beat to prepare its first batch, so
    nothing mutates at t=0 and the base snapshot is a real epoch).
    """

    log: Any                       # GraphEpochLog (duck-typed: .ingest/.current)
    batches: Sequence[tuple]       # [(src, dst), ...] applied in order
    interval_ns: float             # modeled ns between batch applications
    start_ns: float = 0.0          # modeled time the writer session starts

    def times_ns(self) -> np.ndarray:
        """Modeled application time of every batch (strictly increasing)."""
        if self.interval_ns <= 0:
            raise ValueError("interval_ns must be positive")
        n = len(self.batches)
        return self.start_ns + self.interval_ns * np.arange(1, n + 1)


class AdmissionController:
    """Caps concurrently running sessions by pool pressure.

    Reuses the queue-depth fairness idea of ``serving.engine.plan_group_width``
    in reverse: instead of shrinking a request's width so P is shared among
    queued requests, it bounds the number of *admitted* sessions so that each
    can still be guaranteed ``target_share`` workers — ``cap = max(P //
    target_share, 1)``, optionally clamped by ``max_inflight``. Sessions over
    the cap wait in FIFO order and are admitted as running sessions drain.

    ``class_quotas`` adds per-priority-class quotas on top of the global cap:
    ``{priority: max_inflight_for_that_class}``. A class at its quota does
    not block other classes — its waiters are skipped (kept in order) while
    eligible lower-priority waiters behind them are admitted, so a quota'd
    burst of one class can never head-of-line-block the rest of the system.
    Classes absent from the dict are bounded only by the global cap."""

    def __init__(
        self,
        *,
        target_share: int = 1,
        max_inflight: int | None = None,
        class_quotas: dict[int, int] | None = None,
    ):
        if target_share < 1:
            raise ValueError("target_share must be >= 1")
        if max_inflight is not None and max_inflight < 1:
            raise ValueError("max_inflight must be >= 1")
        if class_quotas is not None and any(q < 1 for q in class_quotas.values()):
            raise ValueError("class quotas must be >= 1")
        self.target_share = target_share
        self.max_inflight = max_inflight
        self.class_quotas = dict(class_quotas) if class_quotas else None
        # width-feedback-aware admission (ROADMAP item): when the engine
        # installs a callable here (``EngineConfig(adaptive_admission=True)``
        # with width feedback active), ``cap`` shrinks the per-session share
        # guarantee to the width table's measured efficiency frontier — the
        # widest width that still measures efficient. If wide execution
        # measures poorly, sessions cannot productively use ``target_share``
        # workers each, so guaranteeing it just strands capacity behind the
        # admission cap; admitting more narrow sessions is strictly better.
        # None (the default) is the static heuristic, byte for byte.
        self.frontier_fn: Callable[[], int] | None = None
        self.inflight = 0
        self.inflight_by_class: collections.Counter[int] = collections.Counter()
        # (-priority, fifo_seq, session): highest priority first, FIFO within
        # a class — a latency-sensitive session must not queue behind the
        # whole low-priority backlog
        self._waiting: list[tuple[int, int, Any]] = []
        self._enqueued = 0

    def cap(self, pool: WorkerPool) -> int:
        """Current global admission cap derived from the pool's capacity."""
        share = self.target_share
        if self.frontier_fn is not None:
            # measured efficiency frontier: never *lower* the cap below the
            # static heuristic — a frontier wider than target_share means
            # wide execution measures fine and the static guarantee stands
            share = min(share, max(int(self.frontier_fn()), 1))
        derived = max(pool.capacity // share, 1)
        if self.max_inflight is not None:
            derived = min(derived, self.max_inflight)
        return derived

    def quota_for(self, priority: int) -> int | None:
        """Per-class in-flight quota, or ``None`` for an unbounded class."""
        if self.class_quotas is None:
            return None
        return self.class_quotas.get(int(priority))

    def _class_full(self, priority: int) -> bool:
        quota = self.quota_for(priority)
        return quota is not None and self.inflight_by_class[int(priority)] >= quota

    def _admit_one(self, priority: int) -> None:
        self.inflight += 1
        self.inflight_by_class[int(priority)] += 1

    def try_admit(self, pool: WorkerPool, *, priority: int = 0) -> bool:
        """Admit immediately if neither the cap nor the class quota blocks
        (bypasses the waiter queue — arrivals should use :meth:`submit`)."""
        if self.inflight >= self.cap(pool) or self._class_full(priority):
            return False
        self._admit_one(priority)
        return True

    @property
    def has_waiters(self) -> bool:
        """True while any session queues for admission."""
        return bool(self._waiting)

    @property
    def waiting_count(self) -> int:
        """Sessions queued for admission (the governor's backlog signal)."""
        return len(self._waiting)

    def enqueue(self, session: Any) -> None:
        """Queue a session for admission (priority-FIFO order)."""
        prio = int(getattr(session, "priority", 0))
        heapq.heappush(self._waiting, (-prio, self._enqueued, session))
        self._enqueued += 1

    def submit(self, session: Any, pool: WorkerPool) -> list[Any]:
        """Arrival path: strictly priority-FIFO. The arrival queues behind
        already-waiting sessions of >= priority instead of jumping the line
        (calling ``try_admit`` directly admitted a fresh priority-0 arrival
        ahead of a waiting high-priority session). Returns every session
        admitted now — possibly including the arrival itself."""
        self.enqueue(session)
        return self.drain(pool)

    def drain(self, pool: WorkerPool) -> list[Any]:
        """Admit eligible waiters up to ``cap(pool)`` in priority-FIFO order,
        skipping (but keeping) waiters whose class is at quota. Call after
        anything that raises the cap (a ``pool.resize`` grow, a
        ``max_inflight`` change) — waiters must not stay stranded until some
        unrelated session happens to finish."""
        admitted: list[Any] = []
        skipped: list[tuple[int, int, Any]] = []
        cap = self.cap(pool)
        while self._waiting and self.inflight < cap:
            item = heapq.heappop(self._waiting)
            prio = -item[0]
            if self._class_full(prio):
                skipped.append(item)
                continue
            self._admit_one(prio)
            admitted.append(item[2])
        for item in skipped:
            heapq.heappush(self._waiting, item)
        return admitted

    def release(self, pool: WorkerPool, *, priority: int = 0) -> list[Any]:
        """A session finished: drain every now-eligible waiter (not just one —
        a grown pool or raised ``max_inflight`` may have room for several).
        ``priority`` is the finishing session's class, so its quota slot is
        returned."""
        self.inflight = max(self.inflight - 1, 0)
        prio = int(priority)
        if self.inflight_by_class[prio] > 0:
            self.inflight_by_class[prio] -= 1
        return self.drain(pool)

    def reset(self) -> None:
        """Drop all admission state (run teardown / crash recovery)."""
        self.inflight = 0
        self.inflight_by_class.clear()
        self._waiting.clear()
        self._enqueued = 0


@dataclasses.dataclass
class _SessionState:
    sid: int
    priority: int = 0
    next_query: int = 0
    # (session, query) of the current query: the key of its trace spans
    key: tuple[int, int] | None = None
    executor: QueryExecutor | None = None
    record: QueryRecord | None = None
    prep: PreparedIteration | None = None
    srun: ScheduleRun | None = None
    iter_modeled_ns: float = 0.0
    iter_measured_ns: float = 0.0
    # work-stealing: identity of the graph this session last executed on
    # (locality preference persists after the session drains), the steal job
    # currently in flight, and whether the session is waiting for donated
    # packages to return before accounting its iteration
    graph_key: Any = None
    steal: "_StealJob | None" = None
    joining: bool = False
    # gang fusion: ``fusion`` marks a *driver* state (the synthetic entity
    # that steps a FusionGroup's fused run; sid < 0, never in ``records``);
    # ``fused_member`` marks a real session whose current iteration rides
    # (or rode — de-fuse keeps it set until accounting) a fused gang;
    # ``pending_shares`` is the driver's in-flight gang step, committed to
    # the members when its completion event fires
    fusion: "FusionGroup | None" = None
    fused_member: "FusionMember | None" = None
    pending_shares: list = dataclasses.field(default_factory=list)
    # locality domains (multi-domain runs only; all None/1.0 when
    # domains == 1): ``domain`` is where this session's grants come from
    # this iteration, ``home_domain`` is where its frontier's degree mass
    # concentrates most; ``remote_factor`` scales every step of the
    # iteration by the interconnect cost of the mass sitting *outside* the
    # placed domain (1.0 ≤ factor ≤ c_remote_factor — locality placement
    # minimizes it, blind placement pays it); ``pending_migration_ns`` is
    # the one-time migration cost charged to the first step after a
    # placement move
    domain: int | None = None
    home_domain: int | None = None
    remote_factor: float = 1.0
    pending_migration_ns: float = 0.0


@dataclasses.dataclass
class _StealJob:
    """One in-flight stolen batch: a thief executing victim packages.

    Victim-side objects are captured at claim time — the victim cannot move
    to its next iteration/query until the donation returns, but capturing
    makes that independence explicit."""

    victim: _SessionState
    run: ScheduleRun
    record: QueryRecord | None
    batch: np.ndarray
    workers: int
    modeled_ns: float
    measured_ns: float
    # fused victim only: per-member split of the stolen batch —
    # (member, local_ids, modeled_ns, measured_ns) — plus the group that
    # books the shares when the batch returns
    shares: list | None = None
    group: "FusionGroup | None" = None
    # locality domain the thief's workers were requested from (None on
    # single-domain runs); the completion release must return them there
    domain: int | None = None


class MultiQueryEngine:
    """Gang-scheduling engine for concurrent graph queries."""

    def __init__(
        self,
        hw: HardwareModel,
        *,
        pool_capacity: int | None = None,
        seq_package_limit: int = 4,
        policy: str = "scheduler",
        feedback: CostFeedback | None = None,
        width_feedback: bool = True,
        admission: AdmissionController | None = None,
        high_priority_reserve: int = 0,
        backend: ExecutionBackend | str | None = "modeled",
        calibration: "CalibrationStore | str | None" = None,
    ):
        if policy not in ("scheduler", "sequential", "simple"):
            raise ValueError(f"unknown policy {policy!r}")
        self.hw = hw
        self.pool = WorkerPool(
            pool_capacity or hw.max_threads,
            high_priority_reserve=high_priority_reserve,
        )
        self.seq_package_limit = seq_package_limit
        self.policy = policy
        # §4.4 feedback loop (paper future work): measured package costs
        # correct subsequent predictions
        self.feedback = feedback
        # width-keyed feedback (the §4.4 table per (algorithm, width)):
        # every consumer — preparation corrections, fused-gang width sweeps,
        # thief gang sizing — and every per-step width observation is active
        # only when a feedback object is installed AND this flag is on;
        # ``run_sessions(width_feedback=False)`` disables all of it for the
        # run and is byte-identical to the pre-width-feedback engine
        self.width_feedback = bool(width_feedback)
        self._wfb_active = self.width_feedback
        self.admission = admission or AdmissionController()
        # execution substrate (core.backends): where a schedule step's
        # packages actually run. The default ModeledBackend advances the
        # query but echoes the modeled clock as the measurement — fully
        # deterministic; InlineBackend/CudaBackend measure for real
        self.backend: ExecutionBackend = resolve_backend(backend)
        # persistent calibration (core.calibration): when a store holds a
        # refit of this preset for (this host, this backend), start on it —
        # a calibrated engine plans with readable width differentials from
        # the first step instead of re-tripping the censoring gate every
        # process. ``None`` (the default) touches nothing: no file reads,
        # byte-identical engine.
        self._preset_name = hw.name
        if isinstance(calibration, str):
            calibration = CalibrationStore(calibration)
        self.calibration = calibration
        if self.calibration is not None:
            refit = self.calibration.load(self._preset_name, self.backend.name)
            if refit is not None:
                self.hw = refit

    @property
    def _width_fb_on(self) -> bool:
        """True while width-keyed feedback observations/consumers run."""
        return self.feedback is not None and self._wfb_active

    def _width_signature(self, algorithm: str) -> tuple:
        """The feedback signal preparation actually consumes for one
        algorithm: ``width_ratio`` at every candidate width of the Algorithm
        1 sweep (1 and each power of two up to the pool capacity). Two
        preparations with equal signatures make identical decisions, so the
        shared-prep cache stamps entries with this instead of an
        observation counter."""
        assert self.feedback is not None
        ratios = []
        t = 1
        while t <= self.pool.capacity:
            ratios.append(self.feedback.width_ratio(algorithm, t))
            t <<= 1
        return tuple(ratios)

    def _observe_width(
        self, algorithm: str, width: int, modeled_ns: float, measured_ns: float
    ) -> None:
        """Feed one executed step/batch into the width-keyed §4.4 table.

        Called from every path that executes packages at a known width —
        plain schedule steps, fused split-back shares, stolen batches; the
        post-preemption residual runs come back through the plain-step path
        — so no extra measurement plumbing exists anywhere."""
        if self._width_fb_on:
            self.feedback.observe(
                algorithm,
                "parallel" if width >= 2 else "sequential",
                width=width,
                modeled_ns=modeled_ns,
                measured_ns=measured_ns,
            )

    # ------------------------------------------------------------------
    # shared per-iteration path (both run_query and run_sessions)
    # ------------------------------------------------------------------
    def _decide(self, prep: PreparedIteration) -> ThreadBounds:
        """Apply the engine policy: the paper's baselines override bounds."""
        b = prep.bounds
        if self.policy == "sequential":
            return dataclasses.replace(b, parallel=False, t_min=0, t_max=0, n_packages=1)
        if self.policy == "simple":
            # straight-forward range partitioning at full machine width
            p = self.pool.capacity
            t = max(largest_pow2_leq(p), 1)
            return dataclasses.replace(
                b,
                parallel=t >= 2,
                t_min=min(2, t),
                t_max=t,
                n_packages=max(t, 1),
            )
        return b

    def _prepare(
        self,
        executor: QueryExecutor,
        prev: PreparedIteration | None,
        fsize: int,
        fdeg: np.ndarray | None,
        unvisited: float,
        partition: GraphPartition | None = None,
        frontier_vertices: np.ndarray | None = None,
        key: tuple[int, int] | None = None,
    ) -> PreparedIteration:
        """Preparation step; topology-centric algorithms prepare once (§4.5).

        With width feedback active, the preparation consults the measured
        (algorithm, width) correction table, so the plan accounts for the
        widths thief gangs, fused gangs and post-preemption resumes actually
        delivered in earlier iterations. On a multi-domain run ``partition``
        (+ optional ``frontier_vertices``) makes preparation the placement
        decision point too: the plan carries the frontier's per-domain
        degree mass, computed from the same sampled statistics that drive
        packaging. ``key`` is the query's trace key."""
        if prev is not None and executor.desc.kind != "data_driven":
            return prev
        with tracing.span("sched.prepare", key):
            return prepare_iteration(
                executor.desc,
                self.hw,
                executor.graph_stats(),
                fsize,
                frontier_degrees=fdeg,
                unvisited=unvisited,
                p=self.pool.capacity,
                feedback=self.feedback if self._width_fb_on else None,
                partition=partition,
                frontier_vertices=frontier_vertices,
            )

    def _execute_step(
        self,
        executor: QueryExecutor,
        prep: PreparedIteration,
        step: ScheduleStep,
        modeled_ns: float = 0.0,
    ) -> float:
        """Dispatch one schedule step through the execution backend; returns
        the backend's measured ns.

        ``prepare`` runs *before* the measured window — backend staging and
        kernel warm-up never pollute the first step's measurement, so the
        width-feedback EWMA only ever sees steady-state execution time.
        ``modeled_ns`` is the step's modeled cost, passed through for
        substrates (ModeledBackend) that echo it instead of measuring."""
        plan = self.backend.prepare(executor, prep)
        return float(self.backend.execute(plan, step, modeled_ns=modeled_ns))

    def _step_cost_ns(
        self, desc: AlgorithmDescriptor, prep: PreparedIteration, step: ScheduleStep
    ) -> float:
        """Modeled duration of one step: the iteration cost at the step's
        parallelism, scaled by the fraction of packages it covers."""
        n_pkg = max(prep.packages.n_packages, 1)
        t = step.workers if step.mode == "parallel" else 1
        return iteration_cost_ns(desc, self.hw, prep.work, t=t) * (len(step.batch) / n_pkg)

    def _account_iteration(
        self,
        executor: QueryExecutor,
        record: QueryRecord,
        trace: ScheduleTrace,
        modeled_ns: float,
        measured_ns: float,
    ) -> None:
        """Book one finished iteration into the record + feedback loop."""
        record.modeled_ns += modeled_ns
        record.measured_ns += measured_ns
        record.iterations += 1
        # an iteration counts as parallel when any gang ran multi-worker —
        # including a thief's gang executing stolen packages
        par_mode = any(r.mode == "parallel" or r.workers >= 2 for r in trace.runs)
        if par_mode:
            record.parallel_iterations += 1
        record.traces.append(trace)
        if self.feedback is not None:
            self.feedback.observe(
                executor.desc.name,
                "parallel" if par_mode else "sequential",
                modeled_ns=modeled_ns,
                measured_ns=measured_ns,
            )

    def _run_iteration(
        self,
        executor: QueryExecutor,
        record: QueryRecord,
        prep: PreparedIteration,
        scheduler: PackageScheduler,
    ) -> ScheduleTrace:
        """Execute one full iteration synchronously (run_query path)."""
        bounds = self._decide(prep)
        srun = scheduler.begin(prep.packages, bounds)
        modeled = 0.0
        measured = 0.0
        try:
            while (step := srun.next_step()) is not None:
                if step.mode == "stalled":
                    # no event loop to wait in: a synchronous iteration on a
                    # drained pool cannot proceed without phantom workers
                    raise RuntimeError(
                        "worker pool exhausted: a schedule step must hold >= 1 worker"
                    )
                step_modeled = self._step_cost_ns(executor.desc, prep, step)
                step_measured = self._execute_step(executor, prep, step, step_modeled)
                measured += step_measured
                modeled += step_modeled
                self._observe_width(
                    executor.desc.name,
                    step.workers if step.mode == "parallel" else 1,
                    step_modeled,
                    step_measured,
                )
        finally:
            srun.close()
        self._account_iteration(executor, record, srun.trace, modeled, measured)
        return srun.trace

    # ------------------------------------------------------------------
    def run_query(self, executor: QueryExecutor, record: QueryRecord) -> None:
        """Execute a single query to completion against the live pool.

        Updates ``record`` with measured/modeled time and decision traces.
        """
        executor.start()
        scheduler = PackageScheduler(
            self.pool,
            seq_package_limit=self.seq_package_limit,
            priority=record.priority,
        )
        prep: PreparedIteration | None = None
        while not executor.finished():
            fsize, fdeg, unvisited = executor.frontier()
            if fsize <= 0:
                break
            prep = self._prepare(executor, prep, fsize, fdeg, unvisited)
            self._run_iteration(executor, record, prep, scheduler)
        record.edges = float(executor.edges_traversed())

    # ------------------------------------------------------------------
    def run_sessions(
        self,
        make_executor: Callable[[int, int], QueryExecutor],
        *,
        sessions: int,
        queries_per_session: int,
        config: EngineConfig | None = None,
    ) -> EngineReport:
        """Run ``sessions`` concurrent sessions of repeated queries.

        The run's workload shape and engine features are described by one
        :class:`~.config.EngineConfig` value (``config=``); ``None`` is the
        bare engine (``EngineConfig()``). ``config.backend`` additionally
        overrides the engine's execution substrate for this run only (see
        :mod:`~.backends`); every schedule step — plain, fused, stolen —
        dispatches through it, and its measured times flow into the
        feedback plumbing.

        Discrete-event simulation on the modeled clock. Sessions arrive at
        t=0 (closed loop) or along an open-loop arrival stream; the admission
        controller bounds how many run at once. Each admitted session drives
        the full §4.3 protocol stepwise: a schedule step executes the real
        JAX compute inline (measured clock) and occupies the granted workers
        for its modeled duration, after which the grant is re-evaluated — so
        when many sessions are in flight, grants shrink below T_min and
        queries selectively fall back to sequential execution, with
        ``seq_package_limit`` / early release honoured mid-iteration.

        With ``steal=True`` sessions also cooperate across query boundaries:
        every iteration's :class:`~.scheduler.ScheduleRun` publishes its
        undispatched backlog in a :class:`~.stealing.StealRegistry`, and a
        session that drained its own queries (or sits between queries while
        the pool has spare workers) claims trailing packages from the most
        attractive victim — same-graph first, then priority, then backlog —
        and executes them through the victim's executor. The victim's
        iteration is accounted only after all donations return, so modeled
        time, edges, and convergence stay exact.

        A :class:`~.governor.CapacityGovernor` passed as ``governor`` is
        ticked once per dequeued event: it may elastically resize the pool
        within its ``[p_min, p_max]`` band (grows wake parked runs and drain
        stranded admission waiters through the pool's resize hook; shrinks
        become grant debt, never minted capacity) and — with ``preempt=True``
        — fence a low-priority run at its next package boundary to free
        workers for a parked high-priority session. ``governor=None`` (the
        default) performs zero governor calls and keeps every scheduling
        decision bit-identical to the ungoverned engine.

        With ``fuse=True`` (or an explicit :class:`~.fusion.FusionConfig` as
        ``fusion``) sessions reaching an iteration boundary with a
        parallel-worthy plan rendezvous per ``(graph, algorithm)``: when ≥ 2
        stage together and their summed ``T_max`` exceeds the pool capacity,
        a :class:`~.fusion.FusionGroup` merges their next iterations into
        one fused :class:`~.scheduler.ScheduleRun` — one grant request, one
        interleaved package table, the gang launch overhead charged once and
        split across members — and every executed batch is split back per
        member so records, latencies and EPS stay per-session truthful.
        Fused runs stay stealable and preemptible at package boundaries; a
        governor fence de-fuses the gang (members resume independently over
        their residual packages) and a member whose packages drain early
        leaves at the next boundary. ``fuse=False`` (the default) performs
        zero fusion calls and keeps every decision bit-identical to the
        fusion-less engine.

        ``width_feedback`` controls the §4.4 *width-keyed* feedback table
        for this run (``None`` → the engine's constructor setting, default
        on). Active only when a :class:`~.feedback.CostFeedback` is
        installed, it (a) feeds every executed step/batch — plain schedule
        steps, fused split-back shares, stolen batches, post-preemption
        residual steps — into per-(algorithm, width) corrections, and (b)
        lets three consumers read them: preparation scores candidate widths
        with measured ratios, the fusion flush sweeps the gang width over
        the aggregated member work, and thieves size their gangs by measured
        width efficiency. ``width_feedback=False`` performs zero width-table
        calls and keeps every scheduling decision byte-identical to the
        width-feedback-less engine (the fig10–16 modeled rows are
        unchanged).

        ``config.domains > 1`` splits the pool into locality domains (NUMA
        sockets, TPU slices): each session's graph is partitioned once into
        ``domains`` contiguous degree-balanced shards, every iteration is
        placed on a domain at preparation time (``placement="locality"``
        follows the frontier's per-domain degree mass and re-evaluates when
        the frontier drifts; ``"round_robin"`` is the locality-blind
        control), grants come from the placed domain's capacity slice,
        thieves prefer same-domain victims, gangs never straddle a domain
        boundary (the rendezvous key carries the domain), a governor resizes
        per-domain from per-domain utilization timelines, and — with
        ``migration_penalty`` on — off-home steps pay the contention model's
        remote factor while placement moves and cross-domain steals pay the
        one-time migration cost. ``domains=1`` (the default) performs zero
        partition/domain calls and keeps every scheduling decision
        byte-identical to the pre-domain engine (the fig10–18 modeled rows
        are unchanged).

        ``config.dynamic`` turns on dynamic-graph mode: an
        :class:`IngestStream` writer (``config.ingest``) applies timed edge
        batches between DES events and publishes immutable epoch snapshots
        through its :class:`~repro_torch.graph.epochs.GraphEpochLog`; every query
        record stamps the epoch of the snapshot it pinned at start, and the
        shared prep cache's staleness stamp gains that epoch. Because the
        snapshot ``epoch`` is a component of ``Graph.key``, fusion
        rendezvous, steal locality, partitions, and the backend's per-graph
        tables distinguish snapshots without further plumbing — no gang
        ever mixes members pinned to different snapshots. ``dynamic=False`` (the
        default) performs zero epoch calls and keeps every scheduling
        decision byte-identical to the static-graph engine (the fig10–21
        modeled rows are unchanged).

        With tracing on (:mod:`~.tracing`) the run is one ``engine.round``
        span."""
        with tracing.span("engine.round"):
            return self._run_sessions(
                make_executor,
                sessions=sessions,
                queries_per_session=queries_per_session,
                config=config,
            )

    def _run_sessions(
        self,
        make_executor: Callable[[int, int], QueryExecutor],
        *,
        sessions: int,
        queries_per_session: int,
        config: EngineConfig | None,
    ) -> EngineReport:
        """The body of :meth:`run_sessions`."""
        cfg = config if config is not None else EngineConfig()
        priorities = cfg.priorities
        arrivals = cfg.arrivals
        steal = bool(cfg.steal)
        governor = cfg.governor
        hetero = bool(cfg.hetero_fuse)
        fuse = bool(cfg.fuse) or hetero
        fusion = cfg.fusion
        width_feedback = cfg.width_feedback
        domains = int(cfg.domains)
        placement = cfg.placement
        migration_penalty = bool(cfg.migration_penalty)
        dynamic = bool(cfg.dynamic)
        ingest = cfg.ingest

        if priorities is None:
            prio = [0] * sessions
        elif callable(priorities):
            prio = [int(priorities(s)) for s in range(sessions)]
        else:
            prio = [int(p) for p in priorities]
            if len(prio) != sessions:
                raise ValueError("priorities must have one entry per session")

        if arrivals is None:
            arrival_ns = np.zeros(sessions)
        elif isinstance(arrivals, PoissonArrivals):
            arrival_ns = arrivals.times_ns(sessions)
        else:
            arrival_ns = np.asarray(list(arrivals), dtype=np.float64)
            if arrival_ns.shape != (sessions,):
                raise ValueError("arrivals must have one entry per session")

        prev_wfb = self._wfb_active
        if width_feedback is not None:
            self._wfb_active = bool(width_feedback)
        prev_backend = self.backend
        if cfg.backend is not None:
            self.backend = resolve_backend(cfg.backend)
        # the backend whose measurements this run accumulates — a refit
        # persisted after the run must be keyed on it, not on the engine's
        # default backend restored by the teardown
        run_backend_name = self.backend.name
        # width-feedback-aware admission: for this run only, the admission
        # cap's per-session share guarantee follows the width table's
        # measured efficiency frontier — the widest power-of-two width whose
        # corrected throughput still improves on narrower ones, taken over
        # every algorithm the table has seen (the *most parallel* algorithm
        # decides; others strand even less capacity). A cold table reports
        # the full pool capacity, leaving the static heuristic untouched.
        prev_frontier_fn = self.admission.frontier_fn
        if cfg.adaptive_admission and self._width_fb_on:

            def _efficiency_frontier() -> int:
                algos = self.feedback.width_algorithms()
                if not algos:
                    return self.pool.capacity
                frontier = 1
                for a in algos:
                    best_w, best_eff = 1, 0.0
                    w = 1
                    while w <= self.pool.capacity:
                        eff = w / self.feedback.width_ratio(a, w)
                        if eff > best_eff:
                            best_w, best_eff = w, eff
                        w <<= 1
                    frontier = max(frontier, best_w)
                return frontier

            self.admission.frontier_fn = _efficiency_frontier
        # locality domains: split the pool for this run only (restored in the
        # teardown — set_domains requires zero outstanding grants, which the
        # cleanup loop guarantees). ``domains == 1`` leaves the pool alone.
        prev_domains = self.pool.domains
        if domains != prev_domains:
            self.pool.set_domains(domains)
        # one GraphPartition per distinct graph (lazy, keyed by the stable
        # graph identity — two sessions loading the same dataset into
        # distinct objects share one partition); ``None`` marks a graph whose
        # executor exposes no ``.graph`` (placement falls back to round-robin
        # for its sessions)
        partitions: dict[Any, GraphPartition | None] = {}

        def _partition_for(st: _SessionState) -> GraphPartition | None:
            if domains == 1 or st.graph_key is None:
                return None
            if st.graph_key not in partitions:
                g = getattr(st.executor, "graph", None)
                partitions[st.graph_key] = (
                    GraphPartition.build(g, domains) if g is not None else None
                )
            return partitions[st.graph_key]

        records: list[QueryRecord] = []
        report = EngineReport(
            records=records,
            makespan_modeled_ns=0.0,
            makespan_measured_ns=0.0,
            pool_capacity=self.pool.capacity,
            admission_cap=self.admission.cap(self.pool),
            domains=domains,
        )
        report.capacity_timeline.append((0.0, self.pool.capacity))
        if domains > 1:
            report.utilization_by_domain = [[] for _ in range(domains)]
        if governor is not None:
            governor.reset()
        t_start = time.perf_counter_ns()
        states = [_SessionState(sid=s, priority=prio[s]) for s in range(sessions)]
        registry: StealRegistry | None = StealRegistry() if steal else None
        stalled: list[_SessionState] = []

        # gang fusion: ``fusing`` is the active config (None → zero fusion
        # calls anywhere in the loop). Sessions park in ``fusion_staged``
        # between the staging boundary and the flush; ``drivers`` are the
        # synthetic states stepping live fused runs (negative sids);
        # ``prep_cache`` amortizes identical topology-centric preparations
        # across co-staged members (one sampling pass serves the gang).
        fusing: FusionConfig | None = fusion if fusion is not None else (
            FusionConfig() if fuse else None
        )
        fusion_staged: dict[Any, list[tuple[_SessionState, ThreadBounds]]] = {}
        drivers: list[_SessionState] = []
        driver_sid = 0
        # (width-signature | None, PreparedIteration) per key: the first
        # element stamps the feedback state the plan was computed under
        prep_cache: dict[Any, tuple[Any, PreparedIteration]] = {}
        # the governor's view of running entities; rebuilt only when a gang
        # forms or retires (never per event — the DES hot loop must not copy
        # the state list on every pop)
        running_view: list[_SessionState] = states

        def _sync_running() -> None:
            nonlocal running_view
            running_view = states + drivers if drivers else states

        EV_ARRIVE, EV_STEP, EV_STEAL, EV_GOV, EV_FUSE, EV_INGEST = 0, 1, 2, 3, 4, 5
        # payload is a _SessionState for session events, None for heartbeats,
        # the staging key for EV_FUSE flushes, and the batch index for
        # EV_INGEST writer events
        heap: list[tuple[float, int, int, Any]] = []
        seq = 0
        clock = 0.0
        now = 0.0  # time of the event being handled (heartbeats included)

        def _push(t_ev: float, kind: int, state: Any) -> None:
            nonlocal seq
            heapq.heappush(heap, (t_ev, seq, kind, state))
            seq += 1

        for st in states:
            _push(float(arrival_ns[st.sid]), EV_ARRIVE, st)

        # the ingest writer session: one EV_INGEST per timed edge batch
        # (dynamic runs only — a static run pushes zero writer events)
        if dynamic and ingest is not None:
            for bi, t_b in enumerate(ingest.times_ns()):
                _push(float(t_b), EV_INGEST, bi)

        def _sample(t: float) -> None:
            u = self.pool.in_use
            if not report.utilization or report.utilization[-1][1] != u:
                report.utilization.append((t, u))
            if domains > 1 and self.pool.domains == domains:
                # (the second check skips the closing sample taken after the
                # teardown already restored the pool's previous domain split)
                by = self.pool.in_use_by_domain
                for d in range(domains):
                    line = report.utilization_by_domain[d]
                    if not line or line[-1][1] != by[d]:
                        line.append((t, by[d]))

        def _sample_inflight(t: float) -> None:
            n = self.admission.inflight
            if not report.inflight or report.inflight[-1][1] != n:
                report.inflight.append((t, n))

        def _wake_stalled(t: float) -> None:
            """Re-schedule parked sessions that could now get a worker (their
            priority class sees capacity above the reserve floor). Highest
            priority wakes first, so workers a preemption (or grow) just freed
            go to the session they were freed for — the stable sort keeps the
            park order within a class, so equal-priority runs are unchanged."""
            if not stalled:
                return
            avail = self.pool.available
            if avail <= 0:
                return
            still: list[_SessionState] = []
            for s in sorted(stalled, key=lambda s: -s.priority):
                floor = 0 if s.priority >= 1 else self.pool.high_priority_reserve
                ok = avail > floor
                if ok and domains > 1 and s.domain is not None:
                    # a parked multi-domain run re-requests from its placed
                    # domain: waking it against global availability alone
                    # would spin it through a zero-grant stall
                    ok = self.pool.available_in(s.domain) > 0
                if ok:
                    _push(t, EV_STEP, s)
                else:
                    still.append(s)
            stalled[:] = still

        def _on_resize(old_cap: int, new_cap: int) -> None:
            """The single capacity-change hook (WorkerPool.resize fires it):
            record the timeline, and on growth immediately drain stranded
            admission waiters and wake zero-grant parked runs — a bare grow
            must never leave them parked until an unrelated release."""
            if report.capacity_timeline[-1][1] != new_cap:
                report.capacity_timeline.append((now, new_cap))
            if new_cap > old_cap:
                for adm in self.admission.drain(self.pool):
                    _push(now, EV_STEP, adm)
                _sample_inflight(now)
                _wake_stalled(now)

        self.pool.add_resize_hook(_on_resize)

        # a governed run keeps a heartbeat in the event heap so the governor
        # also observes *idle* stretches (no session events fire there — an
        # ungoverned loop would simply jump the clock across the gap, and a
        # post-burst pool would never shrink). The heartbeat re-arms only
        # while other events remain, so it cannot keep the loop alive, and
        # it never advances the work clock (makespan is query completion).
        gov_tick_ns = 0.0
        if governor is not None:
            ref_ns = governor.config.window_ns
            if governor.config.cooldown_ns > 0:
                ref_ns = min(ref_ns, governor.config.cooldown_ns)
            gov_tick_ns = max(ref_ns / 2.0, 1.0)
            _push(gov_tick_ns, EV_GOV, None)

        def _begin_query(st: _SessionState, t: float) -> bool:
            """Move the session to its next query; False → session exhausted."""
            if st.next_query >= queries_per_session:
                return False
            submitted_wall_ns = time.perf_counter_ns()
            st.key = (st.sid, st.next_query)
            with tracing.span("executor.start", st.key):
                st.executor = make_executor(st.sid, st.next_query)
                st.executor.start()
            # stable dataset identity (not id()): two sessions that loaded
            # the same graph into distinct objects still group for steal
            # locality and gang fusion
            st.graph_key = graph_identity(st.executor)
            st.record = QueryRecord(
                session=st.sid,
                query=st.next_query,
                algorithm=st.executor.desc.name,
                priority=st.priority,
                submitted_wall_ns=submitted_wall_ns,
            )
            if dynamic:
                # pin stamp: the snapshot this query starts on is the one it
                # finishes on — later publishes must not touch it (the fig22
                # trace-level assertion reads this back per record)
                st.record.graph_epoch = getattr(
                    getattr(st.executor, "graph", None), "epoch", None
                )
            # closed loop within a session: the next query is submitted the
            # moment the previous one finishes. The first query inherits the
            # session's arrival time so admission wait counts into latency.
            st.record.submitted_ns = float(arrival_ns[st.sid]) if st.next_query == 0 else t
            records.append(st.record)
            st.prep = None
            st.next_query += 1
            return True

        def _finish_query(st: _SessionState, t: float) -> None:
            if st.executor is not None and st.record is not None:
                st.record.edges = float(st.executor.edges_traversed())
                st.record.finished_ns = t
                st.record.finished_wall_ns = time.perf_counter_ns()
            st.executor = None

        def _place(st: _SessionState) -> None:
            """Placement decision point (multi-domain only): pin the
            session's next iteration to a domain.

            ``locality`` follows the plan's per-domain degree mass — argmax,
            with near-ties (≥ 98% of the max) broken toward the least-loaded
            domain so whole-graph topology sessions spread instead of piling
            onto shard 0 — and re-evaluates every preparation, i.e. exactly
            when the frontier drifts. ``round_robin`` ignores the graph. A
            placement *move* books the one-time migration cost against the
            iteration's first step (the frontier state crosses the
            interconnect once)."""
            if domains == 1:
                return
            mass = st.prep.domain_mass if st.prep is not None else None
            if mass is None or mass.size == 0 or float(mass.sum()) <= 0.0:
                # no placement signal (no ``.graph`` on the executor, empty
                # frontier): fall back to round-robin and call it home
                new_dom = st.sid % domains
                st.home_domain = new_dom
                st.remote_factor = 1.0
            else:
                # "home" is any domain holding a near-maximal share of the
                # frontier's degree mass (≥ 98% of the best) — on a
                # degree-balanced partition a whole-graph frontier makes
                # every domain home, and placement only matters when the
                # frontier genuinely concentrates
                best = float(mass.max())
                cands = [d for d in range(domains) if mass[d] >= 0.98 * best]
                if placement == "round_robin":
                    new_dom = st.sid % domains
                elif st.domain is not None and float(mass[st.domain]) >= 0.5 * best:
                    # movement hysteresis: a placement move costs a real
                    # migration, so the frontier must drift *materially* —
                    # the placed domain's share decaying below half the best
                    # — before the session follows it (chasing every argmax
                    # flip of a wandering frontier churns migrations faster
                    # than the remote factor it saves)
                    new_dom = st.domain
                else:
                    new_dom = min(cands, key=lambda d: (self.pool.in_use_in(d), d))
                st.home_domain = new_dom if new_dom in cands else int(np.argmax(mass))
                # the interconnect cost is proportional to the degree mass
                # sitting *outside* the placed domain: a step streams that
                # fraction remotely. A concentrated frontier placed on its
                # shard pays ~1.0; placed blindly it pays ~c_remote_factor;
                # a uniform whole-graph frontier pays the same everywhere
                # (placement genuinely does not matter there)
                remote_share = 1.0 - float(mass[new_dom]) / float(mass.sum())
                st.remote_factor = (
                    1.0 + (self.hw.c_remote_factor - 1.0) * remote_share
                    if migration_penalty
                    else 1.0
                )
            if st.domain is not None and new_dom != st.domain and migration_penalty:
                st.pending_migration_ns = self.hw.c_migration_ns
            st.domain = new_dom

        def _try_steal(thief: _SessionState, t: float) -> bool:
            """Claim a batch from the best victim and start executing it.
            Returns True when a steal job was launched (EV_STEAL pushed).
            Victims are tried in rank order: the top pick may be unusable
            right now (its priority class sees no workers past the reserve
            floor, or its backlog vanished) without shadowing the next one."""
            if registry is None or not len(registry):
                return False
            with tracing.span("sched.steal"):
                return _steal(thief, t)

        def _steal(thief: _SessionState, t: float) -> bool:
            """The body of ``_try_steal`` past its empty-registry check."""
            tried: set = set()
            while True:
                entry = registry.pick_victim(
                    thief_key=thief.sid,
                    graph_key=thief.graph_key,
                    exclude=tried,
                    domain=thief.domain,
                )
                if entry is None:
                    return False
                tried.add(entry.key)
                victim: _SessionState = entry.payload
                # the stolen packages belong to the victim's query class, so
                # the request may use the victim's priority (its reserve
                # slice). The gang width observes the *governed* capacity —
                # the budget is the pool's current derived availability past
                # the class floor, and zero while a shrink's grant debt is
                # draining — never the raw P the victim's bounds were
                # prepared against.
                budget = registry.steal_budget(
                    self.pool, priority=max(thief.priority, entry.priority)
                )
                if budget < 1:
                    continue
                if self._width_fb_on and entry.algorithms:
                    # heterogeneous fused victim: the claimable tail mixes
                    # compute bodies — size the thief gang against the
                    # algorithms it would actually run (the tags of the
                    # slots the claim would take; the full member set when
                    # the tail preview is empty)
                    tail = entry.run.tail_tags(
                        budget * (STEAL_CHUNK if entry.run.grinding else 1)
                    )
                    want = registry.thief_gang_width_mixed(
                        self.feedback,
                        tail or list(entry.algorithms),
                        max(entry.run.bounds.t_max, 1),
                        budget,
                    )
                elif self._width_fb_on and entry.algorithm is not None:
                    # size the thief gang from measured width efficiency:
                    # among pow2 widths inside the governed budget, request
                    # the one that measured best for this algorithm, not
                    # blindly the victim's T_max
                    want = registry.thief_gang_width(
                        self.feedback,
                        entry.algorithm,
                        max(entry.run.bounds.t_max, 1),
                        budget,
                    )
                else:
                    want = min(max(entry.run.bounds.t_max, 1), budget)
                if want < 1:
                    continue
                got = self.pool.request(
                    want,
                    priority=max(thief.priority, entry.priority),
                    domain=thief.domain,
                )
                usable = largest_pow2_leq(got)
                if usable < 1:
                    if got:
                        self.pool.release(got, domain=thief.domain)
                    continue
                if got > usable:
                    self.pool.release(got - usable, domain=thief.domain)
                # a grinding victim moves at 1-wide, so take a few packages
                # per thief worker; a width-capped parallel victim still
                # moves at T_max, so take only one per worker to stay
                # load-balanced
                chunk = usable * (STEAL_CHUNK if entry.run.grinding else 1)
                batch = entry.run.donate(chunk, workers=usable)
                if batch.size == 0:
                    self.pool.release(usable, domain=thief.domain)
                    continue
                break
            mode = "parallel" if usable >= 2 else "sequential"
            # a cross-domain steal executes the victim's packages on workers
            # of another domain: the batch streams over the interconnect
            # (remote factor) and the claim itself migrates once
            cross = (
                thief.domain is not None
                and entry.domain is not None
                and entry.domain != thief.domain
            )
            if cross:
                report.cross_domain_steals += 1
            if entry.fused:
                # fused victim: the claimed ids are fused slots — split them
                # back per member, run each member's share through its own
                # executor, and charge the thief gang's launch overhead once
                # for the whole batch (same amortization as the gang itself)
                group = victim.fusion
                assert group is not None
                shares, step_ns = _execute_fused_batch(group, batch, mode, usable)
                if cross and migration_penalty and step_ns > 0:
                    # scale the batch total and every member's modeled share
                    # pro rata, so the split-back accounting carries the
                    # interconnect cost to the records that caused it
                    scale = cross_domain_cost_ns(self.hw, step_ns) / step_ns
                    step_ns *= scale
                    for s in shares:
                        s[3] *= scale
                for slot, positions, local_ids, *_ in shares:
                    group.mark_donated(slot, positions, local_ids, usable)
                thief.steal = _StealJob(
                    victim=victim,
                    run=entry.run,
                    record=None,
                    batch=batch,
                    workers=usable,
                    modeled_ns=step_ns,
                    measured_ns=sum(s[4] for s in shares),
                    shares=[(s[0], s[2], s[3], s[4]) for s in shares],
                    group=group,
                    domain=thief.domain,
                )
            else:
                assert victim.executor is not None and victim.prep is not None
                step = ScheduleStep(batch, mode, usable)
                step_ns = self._step_cost_ns(victim.executor.desc, victim.prep, step)
                if cross and migration_penalty:
                    step_ns = cross_domain_cost_ns(self.hw, step_ns)
                measured = self._execute_step(
                    victim.executor, victim.prep, step, step_ns
                )
                # stolen batches run at a width the victim never planned for:
                # exactly the observations the width table exists to capture
                self._observe_width(
                    victim.executor.desc.name, usable, step_ns, measured
                )
                thief.steal = _StealJob(
                    victim=victim,
                    run=entry.run,
                    record=victim.record,
                    batch=batch,
                    workers=usable,
                    modeled_ns=step_ns,
                    measured_ns=measured,
                    domain=thief.domain,
                )
            report.steal_events.append((t, thief.sid, victim.sid, int(batch.size)))
            _sample(t)
            _push(t + step_ns, EV_STEAL, thief)
            return True

        def _install_run(
            st: _SessionState,
            bounds: ThreadBounds,
            *,
            order: np.ndarray | None = None,
            initial_grant: bool = True,
        ) -> None:
            """Begin the session's own iteration run (solo path, and — with
            ``order``/``initial_grant=False`` — a de-fused member's residual
            run)."""
            with tracing.span("sched.package", st.key):
                _begin_run(st, bounds, order, initial_grant)

        def _begin_run(
            st: _SessionState,
            bounds: ThreadBounds,
            order: np.ndarray | None,
            initial_grant: bool,
        ) -> None:
            """The body of ``_install_run``."""
            scheduler = PackageScheduler(
                self.pool,
                seq_package_limit=self.seq_package_limit,
                priority=st.priority,
            )
            # only parallel-capable runs are published for stealing: a run
            # the cost model (or baseline policy) decided to execute
            # sequentially carries tiny iterations, and fencing it would
            # fragment its tail into per-package dispatches for no possible
            # gain. A preempting governor needs the same fence: without
            # incremental dispatch a run is `done` the moment its one big
            # step is handed out, leaving no package boundary to preempt at.
            fenced = (steal or (governor is not None and governor.preempts))
            st.srun = scheduler.begin(
                st.prep.packages,
                bounds,
                stealable=fenced and bounds.parallel,
                order=order,
                initial_grant=initial_grant,
                domain=st.domain,
            )
            if registry is not None and st.srun.stealable:
                registry.publish(
                    st.sid,
                    st.srun,
                    priority=st.priority,
                    graph_key=st.graph_key,
                    payload=st,
                    algorithm=(
                        st.executor.desc.name if st.executor is not None else None
                    ),
                    domain=st.domain,
                )
            st.iter_modeled_ns = 0.0
            st.iter_measured_ns = 0.0

        # ------------------------------------------------------ gang fusion
        def _execute_fused_batch(
            group: FusionGroup, batch: np.ndarray, mode: str, workers: int
        ) -> tuple[list[list], float]:
            """Run a fused batch through its members' executors and split the
            modeled cost: per-member work at the gang width plus ONE gang
            launch overhead slice shared pro rata — the modeled substance of
            fusion (N members, one spin-up). Returns
            ``([slot, positions, local_ids, modeled, measured], total_ns)``."""
            t_eff = workers if mode == "parallel" else 1
            shares: list[list] = []
            total = 0.0
            # modeled accounting first: per-member work at the gang width
            # plus the overhead slice, fully settled *before* execution so
            # the backend receives each share's final modeled cost (the
            # ModeledBackend echoes it; measuring backends ignore it)
            scans: list[float] = []
            for slot, positions, local_ids in group.split(batch):
                frac = local_ids.size / max(slot.prep.packages.n_packages, 1)
                work_ns = member_work_ns(
                    slot.payload.executor.desc,
                    self.hw,
                    slot.prep.work,
                    t_eff,
                    frac,
                )
                # each member drags its own off-domain mass over the
                # interconnect even inside a gang (1.0 on single-domain runs)
                work_ns *= slot.payload.remote_factor
                if group.scan_shared:
                    scans.append(
                        member_scan_ns(
                            slot.payload.executor.desc,
                            self.hw,
                            slot.prep.work,
                            t_eff,
                            frac,
                        )
                        * slot.payload.remote_factor
                    )
                shares.append([slot, positions, local_ids, work_ns, 0.0])
            if group.scan_shared and len(shares) > 1:
                # heterogeneous scan sharing: the members of this batch ride
                # ONE traversal of the CSR shard — the topology-stream slice
                # of the edge term is charged once (the widest member's
                # scan), not once per member; each share keeps its own
                # compute body's full cost
                adjusted = apply_scan_sharing([s[3] for s in shares], scans)
                for share, a in zip(shares, adjusted):
                    share[3] = a
            total = sum(s[3] for s in shares)
            ov = gang_overhead_ns(self.hw, t_eff, int(batch.size), group.n_packages)
            total += ov
            for share in shares:
                share[3] += ov * (share[2].size / batch.size)
            for share in shares:
                slot, _, local_ids = share[0], share[1], share[2]
                s_step = ScheduleStep(local_ids, mode, workers)
                share[4] = self._execute_step(
                    slot.payload.executor, slot.prep, s_step, share[3]
                )
                # split-back commits carry exact per-member (width, modeled,
                # measured) tuples — feed the width table here so members'
                # next preparations know how the gang width really performed
                self._observe_width(
                    slot.payload.executor.desc.name, t_eff, share[3], share[4]
                )
            return shares, total

        def _finalize_member(slot: FusionMember, t: float) -> None:
            """A member's fused iteration is fully executed: book the
            split-back share into its record and let the session continue."""
            st = slot.payload
            slot.finished = True
            st.fused_member = None
            assert st.executor is not None and st.record is not None
            st.record.fused_packages += slot.trace.fused_packages
            self._account_iteration(
                st.executor, st.record, slot.trace, slot.modeled_ns, slot.measured_ns
            )
            _push(t, EV_STEP, st)

        def _launch_group(
            key: Any, chunk: list[tuple[_SessionState, ThreadBounds]], t: float
        ) -> None:
            """Fuse the staged chunk into one gang and start its driver."""
            nonlocal driver_sid
            staged_triples = [(s, s.prep, b) for s, b in chunk]
            # the rendezvous key carries the members' shared domain (None on
            # single-domain runs): the gang is sized against — and its grants
            # drawn from — that domain's capacity slice, never the whole pool
            dom = key[2]
            gang_cap = (
                self.pool.capacity_of(dom) if dom is not None else self.pool.capacity
            )
            member_descs = [s.executor.desc for s, _ in chunk]
            member_algos = [d.name for d in member_descs]
            mixed = hetero and len(set(member_algos)) > 1
            gang_width = None
            if self._width_fb_on:
                # measured-width planning: one thread_bounds call on the
                # members' aggregated IterationWork, each candidate width
                # scored by the feedback table's measured width ratio —
                # replaces the blind capped-T_max-sum width choice. A mixed
                # gang scores the combined per-algorithm work with each
                # algorithm's OWN correction (and falls back to the most
                # conservative member when any entry is censored)
                if mixed:
                    gang_width = plan_hetero_gang_width(
                        staged_triples,
                        member_descs,
                        self.hw,
                        capacity=gang_cap,
                        feedback=self.feedback,
                    )
                else:
                    gang_width = plan_gang_width(
                        staged_triples,
                        member_descs[0],
                        self.hw,
                        capacity=gang_cap,
                        feedback=self.feedback,
                    )
            group = FusionGroup.build(
                staged_triples,
                capacity=gang_cap,
                gang_width=gang_width,
                domain=dom,
                algorithms=member_algos if hetero else None,
                scan_shared=mixed,
            )
            driver_sid -= 1
            driver = _SessionState(
                sid=driver_sid, priority=max(s.priority for s, _ in chunk)
            )
            driver.fusion = group
            driver.graph_key = key[0]
            driver.domain = dom
            for slot in group.members:
                slot.payload.fused_member = slot
            scheduler = PackageScheduler(
                self.pool,
                seq_package_limit=self.seq_package_limit,
                priority=driver.priority,
            )
            # fused runs always carry the fence: per-boundary dispatch is
            # what makes them stealable, preemptible, and de-fusable — and
            # what lets an uneven member leave early. They publish backlog
            # eagerly: workers the gang's power-of-2 rounding cannot absorb
            # are better spent on a thief's second gang
            driver.srun = scheduler.begin(
                group.packages,
                group.bounds,
                stealable=True,
                eager_backlog=True,
                domain=dom,
                tags=group.packages.tags,
            )
            if registry is not None:
                # a mixed gang has no single algorithm name — publish the
                # distinct member set instead, so a thief sizes its gang
                # against the blend of compute bodies it would actually run
                registry.publish(
                    driver.sid,
                    driver.srun,
                    priority=driver.priority,
                    graph_key=driver.graph_key,
                    payload=driver,
                    fused=True,
                    algorithm=None if mixed else member_algos[0],
                    domain=dom,
                    algorithms=tuple(group.algorithms) if mixed else (),
                )
            drivers.append(driver)
            _sync_running()
            report.fusion_events.append(
                (t, driver.sid, len(group.members), group.n_packages)
            )
            _push(t, EV_STEP, driver)

        def _flush_fusion(key: Any, t: float) -> None:
            """The rendezvous closed: cut the staged sessions into FIFO
            chunks of ``max_members`` and fuse each chunk that is itself
            contended (its summed ``T_max`` exceeds the pool) — an
            uncontended chunk's members run solo, since independent
            full-width gangs are at least as good for them."""
            staged = fusion_staged.pop(key, [])
            if not staged:
                return
            assert fusing is not None
            # contention is judged against the staging domain's capacity
            # slice — the resource the would-be gang actually contends for
            flush_cap = (
                self.pool.capacity_of(key[2])
                if key[2] is not None
                else self.pool.capacity
            )
            solo: list[tuple[_SessionState, ThreadBounds]] = []
            while len(staged) >= 2:
                chunk, staged = (
                    staged[: fusing.max_members],
                    staged[fusing.max_members :],
                )
                if should_fuse(
                    [(s, s.prep, b) for s, b in chunk], capacity=flush_cap
                ):
                    _launch_group(key, chunk, t)
                else:
                    solo.extend(chunk)
            solo.extend(staged)  # at most one FIFO leftover
            for st, bounds in solo:
                _install_run(st, bounds)
                _push(t, EV_STEP, st)

        def _defuse(driver: _SessionState, t: float) -> None:
            """A governor fence landed on the gang: dissolve it. Each member
            resumes independently over its residual package ids — parked with
            a zero-grant run, so the capacity the fence just freed goes to
            the waiting high-priority session first (``_wake_stalled`` wakes
            by priority); members re-request at their own priority when their
            turn comes, exactly like a preempted solo run."""
            group = driver.fusion
            assert group is not None
            if registry is not None:
                registry.withdraw(driver.sid)
            driver.srun.close()
            drivers.remove(driver)
            _sync_running()
            driver.srun = None
            driver.fusion = None
            for slot in group.active():
                st = slot.payload
                slot.defused = True
                slot.trace.preempted += 1  # the fence hit every member
                residual = group.residual(slot)
                if residual.size == 0:
                    if slot.pending_stolen == 0:
                        _finalize_member(slot, t)
                    # else: the returning EV_STEAL finalizes the member
                    continue
                _install_run(st, slot.bounds, order=residual, initial_grant=False)
                stalled.append(st)

        def _fused_step(driver: _SessionState, t: float) -> None:
            """Advance a fused gang by one schedule step (driver event)."""
            group = driver.fusion
            run = driver.srun
            assert group is not None and run is not None
            # the step dispatched at the previous driver event has now
            # completed: commit its per-member shares (split-back accounting)
            if driver.pending_shares:
                for slot, positions, local_ids, mode, workers, modeled, measured in (
                    driver.pending_shares
                ):
                    group.commit_step(
                        slot, positions, local_ids, mode, workers, modeled, measured
                    )
                driver.pending_shares = []
            # a member whose packages drained (via gang steps and/or returned
            # steals) leaves the gang at this package boundary
            for slot in group.active():
                if slot.complete:
                    _finalize_member(slot, t)
            pre_preempt = run.trace.preempted
            step = run.next_step()
            if step is None:
                if registry is not None:
                    registry.withdraw(driver.sid)
                run.close()
                if run.outstanding_donations > 0:
                    # stolen fused batches still out: the last EV_STEAL
                    # re-pushes the driver to finalize and retire
                    driver.joining = True
                    _sample(t)
                    _wake_stalled(t)
                    return
                for slot in group.active():
                    _finalize_member(slot, t)
                drivers.remove(driver)
                _sync_running()
                driver.fusion = None
                driver.srun = None
                _sample(t)
                _wake_stalled(t)
                return
            if step.mode == "stalled":
                if run.trace.preempted > pre_preempt:
                    # governor fence: de-fuse so the members re-queue for
                    # workers individually at their own priorities
                    _defuse(driver, t)
                else:
                    # ordinary zero-grant stall: park the whole gang — it
                    # stays fused and resumes when capacity frees
                    stalled.append(driver)
                _wake_stalled(t)
                return
            # execute the fused batch; the committed shares carry the step's
            # mode/width so the split-back trace stays exact
            shares, total = _execute_fused_batch(
                group, step.batch, step.mode, step.workers
            )
            driver.pending_shares = [
                (s[0], s[1], s[2], step.mode, step.workers, s[3], s[4])
                for s in shares
            ]
            _sample(t)
            _push(t + total, EV_STEP, driver)
            _wake_stalled(t)

        try:
            while heap:
                t, _, kind, st = heapq.heappop(heap)
                now = t
                if kind != EV_GOV and kind != EV_INGEST:
                    # heartbeats and the ingest writer observe time but are
                    # not pool work: the modeled makespan must end at the
                    # last session event (a writer outliving every reader
                    # keeps publishing, but readers define the makespan)
                    clock = max(clock, t)

                if governor is not None:
                    # the governor observes every event edge: it may resize
                    # the pool (hooks wake/drain immediately) or fence a
                    # low-priority run for a parked high-priority session.
                    # Fused-gang drivers are preemption candidates like any
                    # session (their priority is the max of their members, so
                    # a gang carrying a high-priority member is protected)
                    governor.tick(
                        t,
                        pool=self.pool,
                        admission=self.admission,
                        utilization=report.utilization,
                        stalled=stalled,
                        running=running_view,
                        utilization_by_domain=(
                            report.utilization_by_domain if domains > 1 else None
                        ),
                    )

                if kind == EV_GOV:
                    # re-arm only while real events remain — the heartbeat
                    # must not keep a finished loop spinning
                    if heap:
                        _push(t + gov_tick_ns, EV_GOV, None)
                    continue

                if kind == EV_INGEST:
                    # the writer session applies one edge batch between DES
                    # events and publishes the next immutable snapshot.
                    # Readers already running keep the snapshot they pinned;
                    # newly starting queries (make_executor closing over
                    # ``log.current()``) see the new epoch.
                    bsrc, bdst = ingest.batches[st]
                    g = ingest.log.ingest(bsrc, bdst)
                    report.ingest_events.append(
                        (t, int(g.epoch), int(np.asarray(bsrc).size))
                    )
                    # stale-snapshot hygiene: epoch-qualified keys mean an
                    # older epoch's cached partition/prep entries are never
                    # looked up again once no live session pins it — drop
                    # them so a long ingest run doesn't accrete dead plans
                    live = {
                        s.graph_key
                        for s in states + drivers
                        if s.executor is not None
                    }

                    def _stale(gk: Any) -> bool:
                        return (
                            isinstance(gk, tuple)
                            and len(gk) >= 2
                            and gk[0] == g.name
                            and isinstance(gk[1], int)
                            and gk[1] < g.epoch
                            and gk not in live
                        )

                    for gk in [k for k in partitions if _stale(k)]:
                        del partitions[gk]
                    for pck in [k for k in prep_cache if _stale(k[0])]:
                        del prep_cache[pck]
                    continue

                if kind == EV_FUSE:
                    # the gang-formation rendezvous for one (graph, algo) key
                    # closed: fuse or release the staged sessions
                    with tracing.span("sched.fuse"):
                        _flush_fusion(st, t)
                    continue

                if kind == EV_ARRIVE:
                    # strict priority-FIFO: the arrival queues behind waiting
                    # sessions of >= priority instead of being admitted
                    # directly past them
                    for adm in self.admission.submit(st, self.pool):
                        _push(t, EV_STEP, adm)
                    _sample_inflight(t)
                    continue

                if kind == EV_STEAL:
                    # a thief finished executing a stolen batch
                    job = st.steal
                    st.steal = None
                    assert job is not None
                    job.run.donation_done()
                    victim = job.victim
                    if job.shares is not None:
                        # fused victim: book each member's share of the
                        # stolen batch (split-back), then settle whoever the
                        # return unblocked — an early-complete member, a
                        # de-fused member joining on this batch, or the
                        # retiring driver itself
                        group = job.group
                        assert group is not None
                        for slot, local_ids, modeled, measured in job.shares:
                            group.account_stolen(slot, modeled, measured)
                            rec = slot.payload.record
                            if rec is not None:
                                rec.stolen_packages += int(local_ids.size)
                        self.pool.release(job.workers, domain=job.domain)
                        _sample(t)
                        for slot, *_ in job.shares:
                            if slot.finished:
                                continue
                            mst = slot.payload
                            if slot.defused:
                                if mst.srun is not None:
                                    if (
                                        mst.joining
                                        and slot.pending_stolen == 0
                                        and mst.srun.outstanding_donations == 0
                                    ):
                                        mst.joining = False
                                        _push(t, EV_STEP, mst)
                                elif (
                                    slot.pending_stolen == 0
                                    and group.residual(slot).size == 0
                                ):
                                    _finalize_member(slot, t)
                            elif slot.complete:
                                _finalize_member(slot, t)
                        if victim.joining and job.run.outstanding_donations == 0:
                            victim.joining = False
                            _push(t, EV_STEP, victim)
                        _push(t, EV_STEP, st)
                        _wake_stalled(t)
                        continue
                    # the stolen work is the victim's: its busy time and
                    # package count book into the victim's iteration/record
                    victim.iter_modeled_ns += job.modeled_ns
                    victim.iter_measured_ns += job.measured_ns
                    if job.record is not None:
                        job.record.stolen_packages += int(job.batch.size)
                    self.pool.release(job.workers, domain=job.domain)
                    _sample(t)
                    if victim.joining and job.run.outstanding_donations == 0:
                        victim.joining = False
                        _push(t, EV_STEP, victim)
                    _push(t, EV_STEP, st)
                    _wake_stalled(t)
                    continue

                # EV_STEP on a fusion driver: advance the fused gang
                if st.fusion is not None:
                    with tracing.span("sched.fuse"):
                        _fused_step(st, t)
                    continue

                # EV_STEP: advance one session by one schedule step
                if st.srun is None:
                    # between iterations: finish queries / start the next one
                    while True:
                        if st.executor is None:
                            if not _begin_query(st, t):
                                # session drained: help a backlogged victim
                                # before giving the slot up — but never while
                                # an admitted-work waiter needs the slot
                                if (
                                    steal
                                    and not self.admission.has_waiters
                                    and _try_steal(st, t)
                                ):
                                    st = None
                                    break
                                for nxt in self.admission.release(
                                    self.pool, priority=st.priority
                                ):
                                    _push(t, EV_STEP, nxt)
                                _sample_inflight(t)
                                st = None
                                break
                        ex = st.executor
                        assert ex is not None
                        # idle between queries: lend spare machine capacity
                        # to a backlogged victim before starting the next
                        # query — but only with queries of our own left; a
                        # drained session must fall through to the drained
                        # branch, whose waiter guard hands the admission slot
                        # over instead of stealing while others queue
                        can_mid_steal = (
                            steal
                            and st.next_query < queries_per_session
                            and self.pool.available >= 2
                        )
                        with tracing.span("executor.finished", st.key):
                            done = ex.finished()
                        if done:
                            _finish_query(st, t)
                            if can_mid_steal and _try_steal(st, t):
                                st = None
                                break
                            continue
                        with tracing.span("executor.frontier", st.key):
                            fsize, fdeg, unvisited = ex.frontier()
                        if fsize <= 0:
                            _finish_query(st, t)
                            if can_mid_steal and _try_steal(st, t):
                                st = None
                                break
                            continue
                        break
                    if st is None:
                        continue
                    rec = st.record
                    assert rec is not None
                    if rec.started_ns == 0.0 and rec.iterations == 0:
                        rec.started_ns = t
                    # multi-domain: preparation doubles as the placement
                    # decision point — the partition hands the plan its
                    # per-domain degree mass, from the exact frontier when
                    # the executor exposes one (data-driven), or the static
                    # degree mass (topology-centric whole-graph frontiers)
                    part = _partition_for(st)
                    fvert = None
                    if part is not None:
                        fv_fn = getattr(ex, "frontier_vertices", None)
                        if callable(fv_fn):
                            fvert = fv_fn()
                    if (
                        fusing is not None
                        and st.prep is None
                        and st.graph_key is not None
                        and ex.desc.kind == "topology"
                    ):
                        # amortized preparation: co-located topology-centric
                        # queries (same graph, same algorithm, same frontier)
                        # share one sampling/packaging pass — the gang
                        # prepares once, not once per member. Data-driven
                        # frontiers differ in content per session, so they
                        # keep their own preparation. The key covers every
                        # prepare_iteration input: a cheap degree fingerprint
                        # guards against an executor whose equal-size first
                        # frontier carries different degrees per session
                        fp = (
                            None
                            if fdeg is None
                            else (int(len(fdeg)), int(np.asarray(fdeg).sum()))
                        )
                        ck = (
                            st.graph_key,
                            ex.desc.name,
                            fsize,
                            float(unvisited),
                            fp,
                            self.pool.capacity,
                        )
                        # corrections evolve: a prep computed under an older
                        # width table must not serve a newer one. Preparation
                        # consumes the feedback table ONLY through
                        # width_ratio(algorithm, t) at the sweep's candidate
                        # widths, so that tuple is the exact staleness stamp:
                        # the cached *value* is replaced in place when (and
                        # only when) a ratio the plan depends on actually
                        # moved — an observation-counter stamp would
                        # invalidate on every executed step and silently
                        # negate the shared-prep amortization, and stamping
                        # the *key* would strand dead entries
                        ver = (
                            self._width_signature(ex.desc.name)
                            if self._width_fb_on
                            else None
                        )
                        if dynamic:
                            # snapshot-generation stamp, same mechanism as
                            # the width-ratio signature: a prep computed
                            # against one epoch's topology is never served
                            # across an epoch boundary. The epoch-qualified
                            # ``graph_key`` in ``ck`` already separates
                            # snapshots; the stamp keeps the invariant even
                            # for executors whose identity degenerates to
                            # ``id(graph)`` (no ``.key``), and is what the
                            # epoch property suite drives directly
                            ver = (
                                ver,
                                getattr(
                                    getattr(ex, "graph", None), "epoch", None
                                ),
                            )
                        cached = prep_cache.get(ck)
                        if cached is None or cached[0] != ver:
                            # topology-centric plans carry the partition's
                            # *static* degree mass — identical per graph, so
                            # the shared cache stays valid across sessions
                            cached = (
                                ver,
                                self._prepare(
                                    ex,
                                    None,
                                    fsize,
                                    fdeg,
                                    unvisited,
                                    partition=part,
                                    key=st.key,
                                ),
                            )
                            prep_cache[ck] = cached
                        st.prep = cached[1]
                    else:
                        st.prep = self._prepare(
                            ex,
                            st.prep,
                            fsize,
                            fdeg,
                            unvisited,
                            partition=part,
                            frontier_vertices=fvert,
                            key=st.key,
                        )
                    _place(st)
                    with tracing.span("sched.bounds", st.key):
                        bounds = self._decide(st.prep)
                    if (
                        fusing is not None
                        and bounds.parallel
                        and st.graph_key is not None
                    ):
                        # gang-formation rendezvous: park under the
                        # (graph, algorithm) key; the first stager arms the
                        # flush that decides fuse-vs-solo for everyone who
                        # reached a boundary within the hold window
                        # the rendezvous key carries the placed domain: a
                        # gang's members share one grant and one interleaved
                        # package table, so a gang must never straddle a
                        # domain boundary (``None`` on single-domain runs —
                        # the key degenerates to the old (graph, algorithm)).
                        # With heterogeneous scan-sharing on, the key DROPS
                        # the algorithm: every session on the same
                        # (graph, domain) rendezvouses regardless of what it
                        # computes — one topology pass, many compute bodies
                        fkey = (
                            st.graph_key,
                            None if hetero else ex.desc.name,
                            st.domain,
                        )
                        waiting = fusion_staged.setdefault(fkey, [])
                        if not waiting:
                            _push(t + fusing.hold_ns, EV_FUSE, fkey)
                        waiting.append((st, bounds))
                        continue
                    _install_run(st, bounds)

                with tracing.span("sched.package", st.key):
                    step = st.srun.next_step()
                if step is None:
                    # all packages dispatched: release the grant right away —
                    # donated batches still executing on thieves run on the
                    # *thief's* workers, so holding the victim's would idle
                    # them for the whole join
                    if registry is not None:
                        registry.withdraw(st.sid)
                    st.srun.close()
                    if st.srun.outstanding_donations > 0 or (
                        st.fused_member is not None
                        and st.fused_member.pending_stolen > 0
                    ):
                        # wait for the donations to return before accounting
                        # the iteration (the thief's EV_STEAL re-pushes us);
                        # a de-fused member also joins on batches stolen from
                        # the gang before it dissolved
                        _sample(t)
                        _wake_stalled(t)
                        st.joining = True
                        continue
                    trace = st.srun.trace
                    st.srun = None
                    assert st.executor is not None and st.record is not None
                    modeled, measured = st.iter_modeled_ns, st.iter_measured_ns
                    if st.fused_member is not None:
                        # de-fused member: join the fused share of this
                        # iteration with the residual run it just finished
                        slot = st.fused_member
                        st.fused_member = None
                        st.record.fused_packages += slot.trace.fused_packages
                        trace = merge_member_trace(slot.trace, trace)
                        modeled += slot.modeled_ns
                        measured += slot.measured_ns
                    self._account_iteration(
                        st.executor, st.record, trace, modeled, measured
                    )
                    _sample(t)
                    _push(t, EV_STEP, st)
                    _wake_stalled(t)
                    continue

                if step.mode == "stalled":
                    # pool integrity: no worker, no execution — park until a
                    # release frees capacity for this session's class. A
                    # governor fence releases the victim's grant *inside*
                    # next_step, so wake now: the high-priority session the
                    # fence freed workers for must not wait for another event
                    # (no-op otherwise — an ordinary stall frees nothing)
                    stalled.append(st)
                    _wake_stalled(t)
                    continue

                assert st.executor is not None and st.prep is not None
                step_ns = self._step_cost_ns(st.executor.desc, st.prep, step)
                if st.remote_factor != 1.0:
                    # off-domain degree mass streams over the interconnect on
                    # every step — locality-blind placement pays close to the
                    # full remote factor on concentrated frontiers, locality
                    # placement close to nothing
                    step_ns *= st.remote_factor
                if st.pending_migration_ns:
                    step_ns += st.pending_migration_ns
                    st.pending_migration_ns = 0.0
                step_measured = self._execute_step(st.executor, st.prep, step, step_ns)
                st.iter_measured_ns += step_measured
                st.iter_modeled_ns += step_ns
                # plain schedule steps (including post-preemption residual
                # runs) carry (width, modeled, measured) — feed the table
                self._observe_width(
                    st.executor.desc.name,
                    step.workers if step.mode == "parallel" else 1,
                    step_ns,
                    step_measured,
                )
                _sample(t)
                _push(t + step_ns, EV_STEP, st)
                # grant re-evaluation inside next_step may have released
                # surplus workers (parallel rounding, early release)
                _wake_stalled(t)

            if stalled:
                raise RuntimeError(
                    f"{len(stalled)} session(s) deadlocked waiting for workers"
                )
            if any(fusion_staged.values()):
                raise RuntimeError(
                    "fusion staging not drained: a flush event was lost"
                )
        finally:
            # an exception in executor code must not leak held grants,
            # admission slots, or the resize hook on the shared engine state
            self._wfb_active = prev_wfb
            self.backend = prev_backend
            self.admission.frontier_fn = prev_frontier_fn
            self.pool.remove_resize_hook(_on_resize)
            for s in states + drivers:
                if s.srun is not None:
                    s.srun.close()
                    s.srun = None
                if s.steal is not None:
                    self.pool.release(s.steal.workers, domain=s.steal.domain)
                    s.steal = None
                s.fusion = None
                s.fused_member = None
            drivers.clear()
            fusion_staged.clear()
            self.admission.reset()
            # the domain split is per-run state on the shared pool; restore
            # it last — every grant is released by now, which set_domains
            # requires
            if self.pool.domains != prev_domains:
                self.pool.set_domains(prev_domains)

        # censor-triggered recalibration (ROADMAP item): when the run's
        # measured ratios clipped so hard the censoring gate tripped, the
        # preset is far from the executing host — refit it from the raw
        # (width, modeled, measured) pairs instead of just neutralizing the
        # width table, then reset the table so subsequent runs accumulate a
        # *readable* differential width signal against the converged preset.
        if (
            cfg.recalibrate
            and self.feedback is not None
            and self.feedback.censor_tripped()
        ):
            pairs = self.feedback.recalibration_pairs()
            if self.calibration is not None:
                # union the fresh pairs with the persisted provenance set so
                # the refit trains on everything this (host, backend) has
                # ever measured, not just this run's buffer
                pairs = (
                    self.calibration.load_pairs(
                        self._preset_name, run_backend_name
                    )
                    + pairs
                )
            # stable refit name even when the engine already started on a
            # persisted refit (no "+recal+recal" accretion across runs)
            self.hw = recalibrate_preset(
                self.hw, pairs, name=f"{self._preset_name}+recal"
            )
            self.feedback.reset_width_state()
            if self.calibration is not None:
                # persist the refit + its provenance (ROADMAP: recalibration
                # persistence) so the next engine on this host/backend starts
                # calibrated instead of re-tripping the censoring gate
                self.calibration.save(
                    self.hw,
                    pairs,
                    preset=self._preset_name,
                    backend=run_backend_name,
                )

        if governor is not None:
            report.resize_events = list(governor.resize_events)
            report.preemptions = list(governor.preemptions)
        _sample(clock)
        report.makespan_modeled_ns = clock
        report.makespan_measured_ns = float(time.perf_counter_ns() - t_start)
        return report
