"""Elastic capacity governor (ROADMAP top items, unified).

The paper derives parallelization constraints from system properties as well
as algorithm properties — but a fixed pool capacity ``P`` bakes the *system*
side in at configuration time. Under bursty open-loop arrivals that leaves
the runtime either over-provisioned (idle workers bought and unused) or
under-admitting (waiters stranded behind a machine that could grow), exactly
the regime the §4 scheduling protocol is meant to avoid.

:class:`CapacityGovernor` is a two-level control plane over the shared
:class:`~.scheduler.WorkerPool`, in the spirit of two-level scheduling for
concurrent graph jobs (arXiv:1806.00777) while the stealing layer keeps its
Q-Graph-style locality preferences (arXiv:1805.11900) untouched:

* **level 1 — machine capacity.** The governor is ticked from the
  discrete-event session loop and maintains a rolling, time-weighted
  utilization window over the same ``(t, in_use)`` samples the
  ``EngineReport`` timeline collects. Sustained saturation *with backlog*
  (parked zero-grant runs or stranded admission waiters) grows the pool;
  sustained idleness with no backlog shrinks it — always within
  ``[p_min, p_max]``, with hysteresis (a full fresh window plus a cooldown
  between actions) so it never thrashes. A shrink under load is *debt*
  (:attr:`~.scheduler.WorkerPool.shrink_debt`), never minted capacity; a
  grow fires the pool's resize hooks so stranded admission waiters are
  drained and zero-grant parked runs are woken immediately — not at the
  next unrelated release.

* **level 2 — who runs.** Per-priority admission quotas (on
  ``AdmissionController``) bound how many sessions of each class are in
  flight, and — when ``preempt=True`` — a waiting high-priority session
  that is parked with zero grant while the pool is fully checked out causes
  the governor to *fence* the fattest low-priority
  :class:`~.scheduler.ScheduleRun` (reusing the stealing donate/fence boundary,
  i.e. the paper's §4.3 package boundary: no package is interrupted
  mid-execution). The victim yields its whole grant at its next package
  boundary and re-queues for workers at its own priority. Fused gangs
  (``core.fusion``) are candidates like any run — their *driver* is a
  synthetic session state with a **negative sid** (a scheduling entity,
  never a query: it appears in the governor's ``running`` view but never in
  ``EngineReport.records``) whose priority is the max of the members', so a
  gang carrying a high-priority member is never fenced for an equal class —
  and a landed fence *de-fuses* the gang: the engine dissolves it at the
  boundary and each member re-queues independently over its residual
  packages, parked behind the high-priority session the fence served.

Preemption interacts with the §4.4 width feedback loop
(``core.feedback``): a preempted run resumes at whatever width its class
can re-grab — a width its preparation never planned for. The residual
steps' (width, modeled, measured) tuples flow into the width-keyed
correction table through the engine's ordinary step accounting, so later
preparations price those post-preemption widths correctly; the governor
itself needs no extra plumbing for this.

The governor is strictly optional: ``run_sessions(governor=None)`` performs
zero governor calls and keeps every existing path bit-identical.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Iterable, Sequence

from .scheduler import WorkerPool
from ..graph.partition import equal_ranges

#: (modeled time_ns, old_capacity, new_capacity, reason)
ResizeEvent = tuple[float, int, int, str]
#: (modeled time_ns, preempted session id)
PreemptionEvent = tuple[float, Any]


class _DomainWindow:
    """Rolling time-weighted utilization window for one locality domain —
    the per-domain replica of the governor's global sampling machinery
    (incremental integral, O(1) per tick)."""

    def __init__(self) -> None:
        self.samples: collections.deque[tuple[float, int]] = collections.deque()
        self.acc = 0.0
        self.idx = 0
        self.last_action_ns = -float("inf")

    def observe(self, t: float, window_ns: float, timeline: Sequence[tuple[float, int]]) -> None:
        for i in range(self.idx, len(timeline)):
            ts, used = timeline[i]
            if self.samples:
                prev_t, prev_v = self.samples[-1]
                self.acc += (ts - prev_t) * prev_v
            self.samples.append((ts, used))
        self.idx = len(timeline)
        cutoff = t - window_ns
        while len(self.samples) >= 2 and self.samples[1][0] <= cutoff:
            t0, v0 = self.samples.popleft()
            self.acc -= (self.samples[0][0] - t0) * v0

    def utilization(self, t: float, window_ns: float, capacity: int) -> float | None:
        samples = self.samples
        t0 = t - window_ns
        if capacity <= 0 or not samples or samples[0][0] > t0:
            return None
        head_t, head_v = samples[0]
        last_t, last_v = samples[-1]
        acc = self.acc - (t0 - head_t) * head_v + (t - last_t) * last_v
        return min(acc / (window_ns * capacity), 1.0)

    def restart(self, t: float) -> None:
        last = self.samples[-1][1] if self.samples else 0
        self.samples.clear()
        self.acc = 0.0
        self.samples.append((t, last))
        self.last_action_ns = t


@dataclasses.dataclass(frozen=True)
class GovernorConfig:
    """Knobs for :class:`CapacityGovernor` (all times on the modeled clock).

    ``grow_util`` / ``shrink_util`` bound the hysteresis band: the rolling
    time-weighted utilization must sit above/below the bound for a full
    ``window_ns`` before the governor acts, and after every action the window
    restarts and a ``cooldown_ns`` must pass — so capacity moves in deliberate
    steps, not oscillations. Growth is additive by ``grow_step`` (default:
    half the current capacity, i.e. 1.5x) and shrink by ``shrink_step``
    (default: a quarter of the current capacity), both clamped to
    ``[p_min, p_max]``."""

    p_min: int
    p_max: int
    grow_util: float = 0.85
    shrink_util: float = 0.30
    window_ns: float = 1e6
    cooldown_ns: float = 2e6
    grow_step: int | None = None
    shrink_step: int | None = None
    preempt: bool = False

    def __post_init__(self) -> None:
        if self.p_min < 1:
            raise ValueError("p_min must be >= 1")
        if self.p_max < self.p_min:
            raise ValueError("p_max must be >= p_min")
        if not 0.0 < self.grow_util <= 1.0:
            raise ValueError("grow_util must be in (0, 1]")
        if not 0.0 <= self.shrink_util < self.grow_util:
            raise ValueError("shrink_util must be in [0, grow_util)")
        if self.window_ns <= 0 or self.cooldown_ns < 0:
            raise ValueError("window_ns must be > 0 and cooldown_ns >= 0")
        for step in (self.grow_step, self.shrink_step):
            if step is not None and step < 1:
                raise ValueError("resize steps must be >= 1 when given")


class CapacityGovernor:
    """Utilization-driven elastic resize + preemption, ticked from the DES.

    The engine calls :meth:`tick` once per dequeued event with the current
    modeled time and views of the runtime state (pool, admission controller,
    the parked-session list, all session states). The governor never touches
    engine internals beyond the documented surfaces: ``pool.resize`` (whose
    hooks do the wake/drain), ``admission.waiting_count`` and
    ``ScheduleRun.preempt``."""

    def __init__(self, config: GovernorConfig | None = None, **knobs: Any):
        if config is None:
            config = GovernorConfig(**knobs)
        elif knobs:
            raise TypeError("pass either a GovernorConfig or knobs, not both")
        self.config = config
        self.resize_events: list[ResizeEvent] = []
        #: fences *requested* (``(t, sid)``); a fence can die unlanded when a
        #: steal donation empties the victim first — landed fences are
        #: counted by ``ScheduleTrace.preempted``
        self.preemptions: list[PreemptionEvent] = []
        # rolling (t, in_use) window over the EngineReport utilization
        # timeline; within one window the capacity is constant (a resize
        # restarts the window), so the fraction divides by pool.capacity.
        # ``_acc`` is the running integral of in_use between the first and
        # last sample, maintained incrementally so a tick stays O(1) even
        # when per-package dispatch makes the timeline dense.
        self._samples: collections.deque[tuple[float, int]] = collections.deque()
        self._acc = 0.0
        self._timeline_idx = 0
        self._last_action_ns = -float("inf")
        # per-locality-domain rolling windows (only populated when the engine
        # runs a multi-domain pool and feeds per-domain timelines)
        self._domain_windows: dict[int, _DomainWindow] = {}

    @property
    def preempts(self) -> bool:
        """Whether this governor may fence runs (engines start runs with the
        steal fence enabled so a mid-iteration package boundary exists)."""
        return self.config.preempt

    # ------------------------------------------------------------- sampling
    def reset(self) -> None:
        """Forget all rolling state and recorded events (run start)."""
        self.resize_events.clear()
        self.preemptions.clear()
        self._samples.clear()
        self._acc = 0.0
        self._timeline_idx = 0
        self._last_action_ns = -float("inf")
        self._domain_windows.clear()

    def _observe(self, t: float, utilization: Sequence[tuple[float, int]]) -> None:
        """Consume the new tail of the shared ``EngineReport.utilization``
        timeline (the engine samples it after every executed step / steal /
        iteration end, so the values reflect *held* grants — the governor
        does not take its own biased pre-request snapshots)."""
        for i in range(self._timeline_idx, len(utilization)):
            ts, used = utilization[i]
            if self._samples:
                prev_t, prev_v = self._samples[-1]
                self._acc += (ts - prev_t) * prev_v
            self._samples.append((ts, used))
        self._timeline_idx = len(utilization)
        cutoff = t - self.config.window_ns
        # keep one sample at or before the window start so the integral
        # covers the whole window
        while len(self._samples) >= 2 and self._samples[1][0] <= cutoff:
            t0, v0 = self._samples.popleft()
            self._acc -= (self._samples[0][0] - t0) * v0

    def window_utilization(self, t: float, capacity: int) -> float | None:
        """Time-weighted mean ``in_use / capacity`` over the trailing window
        (clamped to 1.0 — in-use can transiently exceed a shrunk capacity
        while grant debt drains); ``None`` until a full window has been
        observed since the last resize (that refill gap *is* the
        hysteresis). O(1): the inter-sample integral is kept incrementally,
        only the boundary segments are corrected here."""
        samples = self._samples
        t0 = t - self.config.window_ns
        if capacity <= 0 or not samples or samples[0][0] > t0:
            return None
        head_t, head_v = samples[0]
        last_t, last_v = samples[-1]
        acc = self._acc - (t0 - head_t) * head_v + (t - last_t) * last_v
        return min(acc / (self.config.window_ns * capacity), 1.0)

    # ------------------------------------------------------------- decisions
    def tick(
        self,
        t: float,
        *,
        pool: WorkerPool,
        admission: Any,
        utilization: Sequence[tuple[float, int]] = (),
        stalled: Sequence[Any] = (),
        running: Iterable[Any] = (),
        utilization_by_domain: Sequence[Sequence[tuple[float, int]]] | None = None,
    ) -> None:
        """One governor step at modeled time ``t`` (cheap; called per event).

        ``utilization`` is the live ``EngineReport.utilization`` timeline,
        ``stalled`` the parked zero-grant sessions, ``running`` every session
        state (duck-typed: ``.priority``, ``.sid``, ``.srun``).

        ``utilization_by_domain`` (one per-domain timeline per locality
        domain, fed by a multi-domain engine) switches capacity control to
        per-domain mode: each domain keeps its own rolling window, cooldown
        and ``[p_min, p_max]`` share, and resizes through
        :meth:`WorkerPool.resize_domain` — a saturated domain grows without
        the idle one masking it in the pool-wide mean. Preemption stays
        global (a fence serves whichever domain the needy session waits on).
        Single-domain pools never take this path."""
        self._observe(t, utilization)
        if self.config.preempt:
            self._maybe_preempt(t, pool, stalled, running)
        if utilization_by_domain is not None and getattr(pool, "domains", 1) > 1:
            self._tick_domains(t, pool, admission, utilization_by_domain, stalled)
            return
        if t - self._last_action_ns < self.config.cooldown_ns:
            return
        util = self.window_utilization(t, pool.capacity)
        if util is None:
            return
        backlog = len(stalled) + int(getattr(admission, "waiting_count", 0))
        cfg, cap = self.config, pool.capacity
        if util >= cfg.grow_util and backlog > 0 and cap < cfg.p_max:
            step = cfg.grow_step if cfg.grow_step is not None else max(cap // 2, 1)
            self._resize(t, pool, min(cap + step, cfg.p_max), "grow")
        elif (
            util <= cfg.shrink_util
            and backlog == 0
            and cap > cfg.p_min
            and pool.shrink_debt == 0
        ):
            step = cfg.shrink_step if cfg.shrink_step is not None else max(cap // 4, 1)
            self._resize(t, pool, max(cap - step, cfg.p_min), "shrink")

    def _tick_domains(
        self,
        t: float,
        pool: WorkerPool,
        admission: Any,
        timelines: Sequence[Sequence[tuple[float, int]]],
        stalled: Sequence[Any],
    ) -> None:
        """Per-domain capacity control: the global grow/shrink rule applied
        to each domain's own utilization window and ``[p_min, p_max]`` share
        (the config bounds split the same way the pool splits capacity).
        Admission waiters carry no domain yet, so they count as backlog for
        every domain — any saturated domain may grow to admit them."""
        cfg = self.config
        d_count = pool.domains
        lo = equal_ranges(cfg.p_min, d_count)
        hi = equal_ranges(cfg.p_max, d_count)
        waiters = int(getattr(admission, "waiting_count", 0))
        for d in range(min(d_count, len(timelines))):
            w = self._domain_windows.setdefault(d, _DomainWindow())
            w.observe(t, cfg.window_ns, timelines[d])
            if t - w.last_action_ns < cfg.cooldown_ns:
                continue
            cap = pool.capacity_of(d)
            util = w.utilization(t, cfg.window_ns, cap)
            if util is None:
                continue
            backlog = (
                sum(1 for s in stalled if getattr(s, "domain", None) == d) + waiters
            )
            p_min_d = max(int(lo[d + 1] - lo[d]), 1)
            p_max_d = max(int(hi[d + 1] - hi[d]), 1)
            if util >= cfg.grow_util and backlog > 0 and cap < p_max_d:
                step = cfg.grow_step if cfg.grow_step is not None else max(cap // 2, 1)
                self._resize_domain(t, pool, d, min(cap + step, p_max_d), "grow", w)
            elif (
                util <= cfg.shrink_util
                and backlog == 0
                and cap > p_min_d
                and pool.shrink_debt_of(d) == 0
            ):
                step = (
                    cfg.shrink_step if cfg.shrink_step is not None else max(cap // 4, 1)
                )
                self._resize_domain(t, pool, d, max(cap - step, p_min_d), "shrink", w)

    def _resize_domain(
        self, t: float, pool: WorkerPool, d: int, new: int, reason: str, w: _DomainWindow
    ) -> None:
        old_cap = pool.capacity_of(d)
        if new == old_cap:
            return
        old_total = pool.capacity
        pool.resize_domain(d, new)  # hooks fire with the global totals
        self.resize_events.append((t, old_total, pool.capacity, f"{reason}[d={d}]"))
        w.restart(t)

    def _resize(self, t: float, pool: WorkerPool, new: int, reason: str) -> None:
        old = pool.capacity
        if new == old:
            return
        pool.resize(new)  # hooks fire here: wake parked runs, drain waiters
        self.resize_events.append((t, old, new, reason))
        # decide the next move on post-resize data only: restart the window,
        # but re-seed it with the last known in-use level — during an idle
        # stretch no new samples arrive at all, and an empty window would
        # freeze the governor mid-drawdown
        last = self._samples[-1][1] if self._samples else 0
        self._samples.clear()
        self._acc = 0.0
        self._samples.append((t, last))
        self._last_action_ns = t

    def _maybe_preempt(
        self, t: float, pool: WorkerPool, stalled: Sequence[Any], running: Iterable[Any]
    ) -> None:
        """Fence one low-priority run when a higher-priority session is
        parked with zero grant and the pool is fully checked out."""
        needy = max((s.priority for s in stalled if s.priority >= 1), default=None)
        if needy is None or pool.available > 0:
            return
        victim = None
        for s in running:
            run = s.srun
            if run is None or s.priority >= needy:
                continue
            if run.preempt_pending:
                return  # one fence in flight at a time — wait for it to land
            if not run.preemptible:
                continue
            # fence the fattest grant of the lowest class first
            rank = (-s.priority, run.granted)
            if victim is None or rank > victim[0]:
                victim = (rank, s)
        if victim is not None and victim[1].srun.preempt():
            self.preemptions.append((t, victim[1].sid))


__all__ = ["CapacityGovernor", "GovernorConfig", "PreemptionEvent", "ResizeEvent"]
