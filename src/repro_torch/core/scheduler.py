"""Runtime component: the work-package scheduler implementing *selective
sequential execution* (paper §4.3).

Protocol (verbatim adaptation):
  1. when a task starts, the runtime requests workers up to the upper thread
     bound T_max from the shared worker pool;
  2. arriving workers register; the scheduler checks whether registered
     workers ≥ T_min (minimum boundary for parallel execution);
  3. if yes → assign packages to the workers for parallel execution;
  4. if no  → one worker executes a package *sequentially* while the others
     wait; the scheduler re-evaluates after each package;
  5. after ``seq_package_limit`` sequential packages it releases all but one
     worker and completes the whole task sequentially.

The pool abstracts the machine: CPU threads in the paper, TPU device groups
here. The scheduler is deliberately decentralized — no central task scheduler
needs to understand graph queries (paper: avoids a central scheduler that
deals with many short heterogeneous tasks).

The protocol is exposed in two forms:

  * :meth:`PackageScheduler.run` — synchronous: execute every package of one
    iteration now (used by ``MultiQueryEngine.run_query`` and by direct
    callers / tests);
  * :meth:`PackageScheduler.begin` → :class:`ScheduleRun` — *stepwise*: each
    :meth:`ScheduleRun.next_step` returns the next batch of packages plus the
    execution mode, holding the worker grant between steps. The discrete-event
    loop in ``MultiQueryEngine.run_sessions`` drives this form so that modeled
    time can pass between packages and grant re-evaluation (§4.3 step 4)
    observes workers freed by other sessions in the meantime.

Both forms share the same state machine, so a single query and a concurrent
session make identical decisions under identical pool states.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Literal

import numpy as np

from .bounds import ThreadBounds
from .packaging import WorkPackages
from ..graph.partition import equal_ranges


class WorkerPool:
    """System-wide execution resource shared by all concurrent queries.

    Capacity = P (cores / devices). Thread-safe so concurrent sessions can
    contend for workers, which is what produces the paper's inter-query
    behaviour (under load, grants shrink and queries fall back to sequential
    execution).

    Accounting is by *outstanding grants*: ``request`` checks workers out,
    ``release`` returns them, and ``available`` is derived as
    ``capacity - outstanding``. A shrink under load therefore becomes debt —
    ``in_use`` keeps reporting every worker still checked out (possibly above
    the new capacity) and no new grant is handed out until the debt has
    drained through releases. Outside a shrink window ``in_use <= capacity``
    always holds.

    ``high_priority_reserve`` workers are withheld from normal-priority
    requests: a request with ``priority >= 1`` may drain the pool completely,
    while ``priority 0`` requests can only draw down to the reserve floor.
    This gives latency-sensitive queries a guaranteed slice of the machine
    without a central scheduler.

    ``resize`` notifies registered *resize hooks* with ``(old, new)`` so that
    every capacity-change consumer (the discrete-event loop's wake/drain of
    parked runs and stranded admission waiters, capacity timelines, the
    governor's own bookkeeping) observes elastic scaling through one path —
    a bare ``resize`` grow must never leave a zero-grant run parked until an
    unrelated release happens to come along.

    With ``domains > 1`` the pool additionally models *locality domains*
    (NUMA sockets, TPU slices): capacity is split across ``D`` domains and a
    ``request(domain=d)`` can only draw from domain ``d``'s share, so the
    per-domain invariant ``in_use_in(d) <= capacity_of(d) + shrink_debt_of(d)``
    holds alongside the global one. ``domains=1`` (the default) takes exactly
    the pre-domain code path — grants, reserve floors and debt arithmetic are
    unchanged, which is what keeps single-domain runs byte-identical."""

    def __init__(
        self, capacity: int, *, high_priority_reserve: int = 0, domains: int = 1
    ):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        if not 0 <= high_priority_reserve < capacity:
            raise ValueError("high_priority_reserve must be in [0, capacity)")
        self.capacity = int(capacity)
        self.high_priority_reserve = int(high_priority_reserve)
        # the *requested* reserve survives shrink/grow cycles: a shrink clamps
        # the effective reserve (it must stay < capacity) but a later grow
        # restores it instead of letting it silently erode
        self._requested_reserve = int(high_priority_reserve)
        self._outstanding = 0  # grants checked out and not yet returned
        self._lock = threading.Lock()
        self._resize_hooks: list[Callable[[int, int], None]] = []
        self.domains = 1
        self._dom_cap: list[int] = [self.capacity]
        self._dom_out: list[int] = [0]
        if domains != 1:
            self.set_domains(domains)

    def set_domains(self, domains: int) -> None:
        """Re-split the pool into ``domains`` locality domains.

        Only legal while no grants are outstanding (domain attribution of
        checked-out workers would be ambiguous). Capacity is split into
        equal contiguous shares; a later :meth:`resize` preserves the split
        proportionally."""
        if domains < 1:
            raise ValueError("domains must be >= 1")
        with self._lock:
            if self._outstanding:
                raise RuntimeError(
                    "cannot change domain layout while grants are outstanding"
                )
            if domains > self.capacity:
                raise ValueError(
                    f"domains ({domains}) cannot exceed capacity ({self.capacity})"
                )
            self.domains = int(domains)
            b = equal_ranges(self.capacity, self.domains)
            self._dom_cap = [int(b[i + 1] - b[i]) for i in range(self.domains)]
            self._dom_out = [0] * self.domains

    def request(self, n: int, *, priority: int = 0, domain: int | None = None) -> int:
        """Grant up to n workers (at least 0); non-blocking.

        ``domain`` confines the grant to one locality domain's share; with
        ``domain=None`` and multiple domains the grant is spread greedily
        over the freest domains (the caller does not care where the workers
        sit — e.g. the admission probe). Single-domain pools ignore the
        distinction entirely."""
        with self._lock:
            floor = 0 if priority >= 1 else self.high_priority_reserve
            free = self.capacity - self._outstanding
            grant = max(min(n, free - floor), 0)
            if self.domains == 1:
                self._outstanding += grant
                self._dom_out[0] = self._outstanding
                return grant
            if domain is not None:
                dom_free = self._dom_cap[domain] - self._dom_out[domain]
                grant = max(min(grant, dom_free), 0)
                self._dom_out[domain] += grant
                self._outstanding += grant
                return grant
            # domain-agnostic request on a multi-domain pool: greedy spread
            remaining, total = grant, 0
            for d in sorted(
                range(self.domains),
                key=lambda d: self._dom_cap[d] - self._dom_out[d],
                reverse=True,
            ):
                if remaining <= 0:
                    break
                take = max(min(remaining, self._dom_cap[d] - self._dom_out[d]), 0)
                self._dom_out[d] += take
                remaining -= take
                total += take
            self._outstanding += total
            return total

    def release(self, n: int, *, domain: int | None = None) -> None:
        """Return ``n`` granted workers to the pool (to ``domain``'s share
        when given; otherwise drained from the most-loaded domains)."""
        with self._lock:
            n = int(n)
            self._outstanding = max(self._outstanding - n, 0)
            if self.domains == 1:
                self._dom_out[0] = self._outstanding
                return
            if domain is not None:
                self._dom_out[domain] = max(self._dom_out[domain] - n, 0)
                return
            remaining = n
            for d in sorted(
                range(self.domains), key=lambda d: self._dom_out[d], reverse=True
            ):
                if remaining <= 0:
                    break
                take = min(remaining, self._dom_out[d])
                self._dom_out[d] -= take
                remaining -= take

    @property
    def available(self) -> int:
        """Workers not currently checked out (never negative)."""
        with self._lock:
            return max(self.capacity - self._outstanding, 0)

    @property
    def in_use(self) -> int:
        """Workers currently checked out. Exceeds ``capacity`` only while a
        shrink's debt is draining (see :attr:`shrink_debt`)."""
        with self._lock:
            return self._outstanding

    @property
    def shrink_debt(self) -> int:
        """Grants above the current capacity (only non-zero after a shrink
        under load); drains to zero as the outstanding grants are released."""
        with self._lock:
            return max(self._outstanding - self.capacity, 0)

    # ---------------- per-domain accessors ----------------

    def capacity_of(self, domain: int) -> int:
        """Capacity of one locality domain's share."""
        with self._lock:
            return self._dom_cap[domain]

    def in_use_in(self, domain: int) -> int:
        """Workers checked out of one domain's share."""
        with self._lock:
            return self._dom_out[domain]

    def available_in(self, domain: int) -> int:
        """Free workers in one domain's share (never negative)."""
        with self._lock:
            return max(self._dom_cap[domain] - self._dom_out[domain], 0)

    def shrink_debt_of(self, domain: int) -> int:
        """Per-domain analogue of :attr:`shrink_debt`."""
        with self._lock:
            return max(self._dom_out[domain] - self._dom_cap[domain], 0)

    @property
    def domain_capacities(self) -> tuple[int, ...]:
        with self._lock:
            return tuple(self._dom_cap)

    @property
    def in_use_by_domain(self) -> tuple[int, ...]:
        with self._lock:
            return tuple(self._dom_out)

    def add_resize_hook(self, hook: Callable[[int, int], None]) -> None:
        """Register ``hook(old_capacity, new_capacity)`` to run after every
        capacity change (outside the pool lock, in registration order)."""
        self._resize_hooks.append(hook)

    def remove_resize_hook(self, hook: Callable[[int, int], None]) -> None:
        """Unregister a hook added by :meth:`add_resize_hook` (idempotent)."""
        if hook in self._resize_hooks:
            self._resize_hooks.remove(hook)

    def resize(self, new_capacity: int) -> None:
        """Elastic scaling: grow/shrink the machine (node join/loss, or the
        capacity governor reacting to sustained saturation / idleness).

        Outstanding grants are untouched: a shrink below ``in_use`` leaves
        the overhang as debt that blocks new grants until released, instead
        of silently minting capacity. Resize hooks fire after the change so
        a grow can wake parked runs / drain admission waiters immediately."""
        if new_capacity < 1:
            raise ValueError("capacity must be >= 1")
        with self._lock:
            old = self.capacity
            self.capacity = int(new_capacity)
            # keep the reserve invariant (< capacity) so a shrink can never
            # permanently starve normal-priority requests — but clamp against
            # the *requested* reserve, so a grow restores what a previous
            # shrink took away instead of compounding the erosion
            self.high_priority_reserve = min(self._requested_reserve, self.capacity - 1)
            if self.domains == 1:
                self._dom_cap[0] = self.capacity
            else:
                # a whole-pool resize preserves the equal split; outstanding
                # per-domain grants above the new share become per-domain debt
                b = equal_ranges(self.capacity, self.domains)
                self._dom_cap = [int(b[i + 1] - b[i]) for i in range(self.domains)]
        if old != self.capacity:
            for hook in list(self._resize_hooks):
                hook(old, self.capacity)

    def resize_domain(self, domain: int, new_capacity: int) -> None:
        """Grow/shrink a single locality domain's share (the per-domain
        governor path). The global capacity moves by the same delta; resize
        hooks fire with the global totals so every capacity-change consumer
        keeps observing scaling through the one path."""
        if new_capacity < 1:
            raise ValueError("domain capacity must be >= 1")
        with self._lock:
            old = self.capacity
            delta = int(new_capacity) - self._dom_cap[domain]
            if delta == 0:
                return
            self._dom_cap[domain] = int(new_capacity)
            self.capacity += delta
            self.high_priority_reserve = min(self._requested_reserve, self.capacity - 1)
        for hook in list(self._resize_hooks):
            hook(old, self.capacity)


@dataclasses.dataclass
class PackageRun:
    """One package's execution record: mode + the width it actually ran at."""

    package: int
    mode: Literal["parallel", "sequential", "stolen"]
    workers: int


@dataclasses.dataclass
class ScheduleTrace:
    """Decision record for one task execution (tests + benchmarks)."""

    requested: int
    runs: list[PackageRun] = dataclasses.field(default_factory=list)
    released_early: bool = False
    # packages ceded to thieves over the victim fence (work-stealing)
    stolen_packages: int = 0
    # times the run was fenced by the capacity governor (grant released at a
    # package boundary to free workers for a waiting high-priority session)
    preempted: int = 0
    # packages this query executed inside a fused gang (gang fusion: the
    # per-member split-back of a multi-session ScheduleRun)
    fused_packages: int = 0

    @property
    def parallel_fraction(self) -> float:
        """Fraction of packages executed by a multi-worker gang — the
        victim's own, or a thief's gang running stolen packages."""
        if not self.runs:
            return 0.0
        return sum(r.workers >= 2 or r.mode == "parallel" for r in self.runs) / len(self.runs)

    def width_histogram(self) -> dict[int, int]:
        """Packages executed per gang width (``{width: count}``).

        Every :class:`PackageRun` records the width its package actually ran
        at — the victim's own steps, a thief gang's stolen runs, and fused
        split-back runs alike — so this is the per-iteration realization of
        the (algorithm, width) axis the §4.4 feedback table corrects along:
        the widths *delivered*, which preparation's ``T_max`` alone cannot
        predict once stealing, fusion or preemption redistribute packages."""
        hist: dict[int, int] = {}
        for r in self.runs:
            w = max(int(r.workers), 1)
            hist[w] = hist.get(w, 0) + 1
        return hist

    @property
    def max_workers(self) -> int:
        """Widest gang that executed any package of this task."""
        return max((r.workers for r in self.runs), default=1)


@dataclasses.dataclass(frozen=True)
class ScheduleStep:
    """One executable unit handed out by :class:`ScheduleRun`.

    ``batch`` holds the package ids to run now; ``workers`` is the group size
    (1 for sequential execution). A ``"stalled"`` step carries no work: the
    run could not check out even one worker, and the caller must wait for a
    release before calling :meth:`ScheduleRun.next_step` again — executing
    work without a held worker would oversubscribe the pool."""

    batch: np.ndarray
    mode: Literal["parallel", "sequential", "stalled"]
    workers: int


#: Sentinel step returned while the pool cannot spare a single worker.
STALL_STEP = ScheduleStep(batch=np.empty(0, dtype=np.int64), mode="stalled", workers=0)


def largest_pow2_leq(n: int) -> int:
    """Largest power of two ≤ ``n`` (usable gang width), 0 for ``n < 1``."""
    if n < 1:
        return 0
    return 1 << (int(n).bit_length() - 1)


class ScheduleRun:
    """Resumable §4.3 protocol over one task's package list.

    Holds its worker grant between :meth:`next_step` calls; every call
    re-requests up to T_max first (grant re-evaluation), so workers freed by
    other sessions while the previous step executed are picked up. The caller
    must :meth:`close` the run (release the grant) when done — ``next_step``
    returning ``None`` means all packages have been handed out.

    A step is only handed out while the run holds at least one granted
    worker; if the pool cannot spare even one, :data:`STALL_STEP` is returned
    and the caller must wait for a release (the discrete-event loop parks the
    session). This keeps ``in_use <= capacity``: no work ever executes
    without occupying a worker.

    With ``stealable=True`` the run additionally maintains a *victim fence*
    for inter-session work-stealing: undispatched packages live in
    ``[cursor, fence)``, a thief claims trailing packages by moving the fence
    down (:meth:`donate`), and the sequential tail is dispatched one package
    per step (instead of as one batch) so the remainder stays claimable while
    the victim grinds. ``next_step`` never crosses the fence, so a claim can
    never race the victim's own dispatch.

    ``order`` overrides the dispatch order / package-id universe: gang fusion
    hands a run the interleaved fused slot ids of several sessions' package
    lists (``packages`` is then only a duck-typed carrier), and a de-fused
    member resumes with a run over just its residual package ids. ``packages``
    only contributes its default order — all batching decisions are made over
    whatever id list the run was given."""

    def __init__(
        self,
        pool: WorkerPool,
        packages: WorkPackages,
        bounds: ThreadBounds,
        *,
        seq_package_limit: int = 4,
        priority: int = 0,
        stealable: bool = False,
        eager_backlog: bool = False,
        order: np.ndarray | None = None,
        initial_grant: bool = True,
        domain: int | None = None,
        tags: np.ndarray | None = None,
    ):
        self.pool = pool
        self.bounds = bounds
        self.seq_package_limit = seq_package_limit
        self.priority = priority
        self.stealable = stealable
        self.eager_backlog = eager_backlog
        # locality domain every grant of this run draws from (None = whole
        # pool); placement decided it once per iteration, so a run never
        # straddles a domain boundary
        self.domain = domain
        if order is not None:
            self._order = np.asarray(order, dtype=np.int64)
        else:
            self._order = packages.order[: packages.n_packages]
        # per-package algorithm tags, indexed by *package id* (heterogeneous
        # fused gangs interleave several algorithms in one order; the fused
        # id universe is 0..n-1 so the id doubles as the index). None on
        # single-algorithm runs — every slot is the run's one algorithm.
        self._tags = tags
        self._cursor = 0
        self._fence = len(self._order)  # thieves claim from the tail down
        self._donations = 0             # claimed batches not yet executed
        self._steal_lock = threading.Lock()
        self._seq_done = 0
        self._closed = False
        self._preempt_pending = False   # governor fence: yield at next boundary
        # preparation already decided sequential → take one worker at most
        self._simple_seq = not bounds.parallel or len(self._order) <= 1
        self._requested = 1 if self._simple_seq else bounds.t_max
        # ``initial_grant=False`` starts the run parked with zero workers —
        # the first ``next_step`` requests at the run's own priority. Used
        # when a run must NOT synchronously re-absorb capacity another
        # consumer was just preempted to free (de-fused members re-queue
        # behind the high-priority session the fence served).
        self._granted = (
            pool.request(self._requested, priority=priority, domain=domain)
            if initial_grant
            else 0
        )
        self.trace = ScheduleTrace(requested=self._requested)

    @property
    def done(self) -> bool:
        """All packages dispatched or donated (donations may still be
        executing on the thief — see :attr:`outstanding_donations`)."""
        return self._cursor >= self._fence

    @property
    def outstanding_donations(self) -> int:
        """Donated batches a thief has claimed but not yet finished; the
        iteration must not be accounted until this returns to zero."""
        return self._donations

    @property
    def grinding(self) -> bool:
        """True while the run is committed to (or stuck in) sequential
        execution — the saturation state the paper's protocol shrinks into."""
        return self._simple_seq or self._seq_done > 0 or self.trace.released_early

    @property
    def granted(self) -> int:
        """Workers the run currently holds checked out of the pool."""
        return self._granted

    @property
    def preempt_pending(self) -> bool:
        """A governor fence is set but the run has not yielded yet."""
        return self._preempt_pending

    @property
    def preemptible(self) -> bool:
        """The run holds workers a preemption could free: alive, not already
        fenced, and at least one worker checked out."""
        return (
            not self._closed
            and not self.done
            and not self._preempt_pending
            and self._granted >= 1
        )

    def preempt(self) -> bool:
        """Governor-side fence: ask the run to release its whole grant at the
        next package boundary (the same boundary the steal fence uses — no
        package is ever interrupted mid-execution). The run's next
        ``next_step`` observes the fence, returns the grant, and reports a
        stall so the event loop parks the session; it re-requests workers at
        its own priority once woken. One-shot: the fence clears when it
        fires. Returns False when the run holds nothing worth preempting."""
        with self._steal_lock:
            if not self.preemptible:
                return False
            self._preempt_pending = True
            return True

    @property
    def width_capped(self) -> bool:
        """True when the run already holds its full T_max — it cannot absorb
        more workers itself, so only a second gang can use idle capacity."""
        return self._granted >= max(self.bounds.t_max, 1)

    @property
    def width_blocked(self) -> bool:
        """The free pool capacity cannot raise this run's usable (power-of-2)
        width: absorbing it would only round back down, so idle workers help
        the system solely as a *second* gang. Distinct from
        :attr:`width_capped` (grant == T_max) — a run can be width-blocked
        far below its T_max when the remainder of the pool is fragmented."""
        usable = largest_pow2_leq(self._granted)
        if usable < 1:
            return False
        avail = (
            self.pool.available
            if self.domain is None
            else self.pool.available_in(self.domain)
        )
        return largest_pow2_leq(self._granted + avail) <= usable

    @property
    def stealable_backlog(self) -> int:
        """Packages a thief may claim right now. Backlog is published while
        the run grinds sequentially (a thief halves the grind) or while it is
        width-capped at T_max (a thief's second gang uses workers the victim
        is not allowed to take) — a parallel run that could still widen keeps
        its packages, since its own grant re-evaluation absorbs freed workers
        faster than a steal round-trip.

        ``eager_backlog`` runs (fused gangs) additionally publish while
        merely *width-blocked*: a gang carries several sessions' packages, so
        idle workers its power-of-2 rounding cannot absorb are better spent
        on a thief's second gang than left parked until the gang drains."""
        if not self.stealable or self._closed:
            return 0
        if not (
            self.grinding
            or self.width_capped
            or (self.eager_backlog and self.width_blocked)
        ):
            return 0
        return max(self._fence - self._cursor, 0)

    def tail_tags(self, k: int) -> list[str]:
        """Distinct algorithm tags among the (up to) ``k`` trailing claimable
        packages — exactly the slots the next :meth:`donate` of size ``k``
        would take. A thief sizing its gang against a heterogeneous fused
        victim scores its width per the algorithms it would actually run;
        empty when the run carries no tags (single-algorithm) or nothing is
        claimable."""
        if self._tags is None:
            return []
        with self._steal_lock:
            k = min(int(k), self.stealable_backlog)
            if k <= 0:
                return []
            batch = self._order[self._fence - k : self._fence]
            seen: list[str] = []
            for pid in batch:
                tag = str(self._tags[int(pid)])
                if tag and tag not in seen:
                    seen.append(tag)
            return seen

    def donate(self, k: int, *, workers: int = 1) -> np.ndarray:
        """Thief-side claim: atomically cede up to ``k`` trailing undispatched
        packages over the fence. Returns the claimed package ids (possibly
        empty). ``workers`` is recorded in the trace for the stolen runs."""
        with self._steal_lock:
            k = min(int(k), self.stealable_backlog)
            if k <= 0:
                return np.empty(0, dtype=np.int64)
            self._fence -= k
            batch = self._order[self._fence : self._fence + k]
            self._donations += 1
            self.trace.stolen_packages += k
            self.trace.runs.extend(PackageRun(int(p), "stolen", workers) for p in batch)
            return batch

    def donation_done(self) -> None:
        """Thief-side completion signal for one claimed batch."""
        with self._steal_lock:
            self._donations = max(self._donations - 1, 0)

    def _seq_tail(self) -> ScheduleStep:
        """Dispatch the committed-sequential remainder: the whole tail at
        once normally, or one package per step when stealable (so the tail
        stays claimable between steps)."""
        end = min(self._cursor + 1, self._fence) if self.stealable else self._fence
        batch = self._order[self._cursor : end]
        self._cursor = end
        self.trace.runs.extend(PackageRun(int(p), "sequential", 1) for p in batch)
        return ScheduleStep(batch, "sequential", 1)

    def next_step(self) -> ScheduleStep | None:
        """Hand out the next executable batch (§4.3 steps 2–5), re-evaluating
        the grant first; ``None`` once every package is dispatched/donated."""
        # the fence lock makes dispatch atomic against a concurrent donate():
        # cursor and fence can never cross mid-claim, so no package is ever
        # handed out twice (the DES is single-threaded, but the run keeps the
        # WorkerPool's thread-safety contract)
        with self._steal_lock:
            return self._next_step_locked()

    def _next_step_locked(self) -> ScheduleStep | None:
        if self.done:
            # a fence set just before a steal donation emptied the range has
            # nothing left to yield — clear it so the governor's
            # one-fence-in-flight guard is not blocked by a dead flag (the
            # grant is released by close() at this same boundary anyway)
            self._preempt_pending = False
            return None
        if self._preempt_pending:
            # governor fence: yield the whole grant at this package boundary
            # so a waiting high-priority session can take the workers; stall
            # until the event loop wakes us with capacity for our class
            self._preempt_pending = False
            if self._granted > 0:
                self.pool.release(self._granted, domain=self.domain)
                self._granted = 0
            self.trace.preempted += 1
            return STALL_STEP
        # pool integrity: a step may never execute without holding a worker
        if self._granted <= 0:
            self._granted = self.pool.request(
                1, priority=self.priority, domain=self.domain
            )
            if self._granted <= 0:
                return STALL_STEP
        if self._simple_seq or self.trace.released_early:
            return self._seq_tail()

        # §4.3 step 4: re-evaluate the grant — workers may have been freed
        # (or arrived) while the previous package executed.
        if self._granted < self._requested:
            self._granted += self.pool.request(
                self._requested - self._granted,
                priority=self.priority,
                domain=self.domain,
            )
        usable = largest_pow2_leq(self._granted)
        if usable >= max(self.bounds.t_min, 2):
            # parallel phase: hand the remaining packages to the group; the
            # non-power-of-2 surplus is unusable — return it to the pool now
            # rather than holding it for the whole step. A stealable run
            # dispatches one package per worker per step so the tail stays
            # behind the fence (claimable by a thief's second gang) and the
            # grant keeps re-evaluating between chunks. Recovering to
            # parallel ends any sequential grind — the run is no longer
            # ``grinding`` and thieves treat it as full-width again.
            self._seq_done = 0
            if self._granted > usable:
                self.pool.release(self._granted - usable, domain=self.domain)
                self._granted = usable
            end = min(self._cursor + usable, self._fence) if self.stealable else self._fence
            batch = self._order[self._cursor : end]
            self._cursor = end
            self.trace.runs.extend(PackageRun(int(p), "parallel", usable) for p in batch)
            return ScheduleStep(batch, "parallel", usable)
        if self._seq_done < self.seq_package_limit:
            # below the parallel boundary: one worker runs one package, the
            # rest wait; re-evaluate on the next call
            batch = self._order[self._cursor : self._cursor + 1]
            self._cursor += 1
            self._seq_done += 1
            self.trace.runs.append(PackageRun(int(batch[0]), "sequential", 1))
            return ScheduleStep(batch, "sequential", 1)
        # give up on parallelism: release all but one worker and finish the
        # whole task sequentially (§4.3 last step)
        if self._granted > 1:
            self.pool.release(self._granted - 1, domain=self.domain)
            self._granted = 1
        self.trace.released_early = True
        return self._seq_tail()

    def close(self) -> None:
        """Return the held grant to the pool (idempotent)."""
        if not self._closed:
            self.pool.release(self._granted, domain=self.domain)
            self._granted = 0
            self._closed = True
        self._preempt_pending = False  # a closed run can honor no fence


class PackageScheduler:
    """Selective sequential execution over one task's package list."""

    def __init__(
        self,
        pool: WorkerPool,
        *,
        seq_package_limit: int = 4,
        priority: int = 0,
    ):
        self.pool = pool
        self.seq_package_limit = seq_package_limit
        self.priority = priority

    def begin(
        self,
        packages: WorkPackages,
        bounds: ThreadBounds,
        *,
        stealable: bool = False,
        eager_backlog: bool = False,
        order: np.ndarray | None = None,
        initial_grant: bool = True,
        domain: int | None = None,
        tags: np.ndarray | None = None,
    ) -> ScheduleRun:
        """Start a stepwise run (requests the initial grant now unless
        ``initial_grant=False``, which starts it parked). ``order``
        restricts/overrides the dispatched package ids (fused gangs, residual
        runs of de-fused members); ``eager_backlog`` loosens the steal fence
        for runs carrying several sessions' packages; ``domain`` pins every
        grant of the run to one locality domain; ``tags`` labels each package
        id with its algorithm (heterogeneous fused gangs)."""
        return ScheduleRun(
            self.pool,
            packages,
            bounds,
            seq_package_limit=self.seq_package_limit,
            priority=self.priority,
            stealable=stealable,
            eager_backlog=eager_backlog,
            order=order,
            initial_grant=initial_grant,
            domain=domain,
            tags=tags,
        )

    def run(
        self,
        packages: WorkPackages,
        bounds: ThreadBounds,
        execute_parallel: Callable[[np.ndarray, int], None],
        execute_sequential: Callable[[np.ndarray], None],
    ) -> ScheduleTrace:
        """Execute all packages of one iteration synchronously.

        execute_parallel(package_ids, t): run the given packages with t-way
        parallelism (device group of size t / t threads).
        execute_sequential(package_ids): run the given packages on one worker.
        """
        srun = self.begin(packages, bounds)
        try:
            while (step := srun.next_step()) is not None:
                if step.mode == "stalled":
                    # the synchronous path has no event loop to wait in — a
                    # fully drained pool here is a caller bug, not a state to
                    # execute through with phantom workers
                    raise RuntimeError(
                        "worker pool exhausted: a schedule step must hold >= 1 worker"
                    )
                if step.mode == "parallel":
                    execute_parallel(step.batch, step.workers)
                else:
                    execute_sequential(step.batch)
        finally:
            srun.close()
        return srun.trace
