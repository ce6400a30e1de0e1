"""Inter-session work-stealing (ROADMAP top item).

The §4.3 protocol only ever *shrinks* a saturated query — sequential
fallback, early release — but never lets idle capacity absorb another
session's backlog. Under skewed concurrent load (one heavy PageRank, many
short BFS) that leaves granted workers idle while a saturated session grinds
its remaining packages one by one. Q-Graph (arXiv:1805.11900) and the
two-level scheduler of arXiv:1806.00777 both redistribute work *between*
concurrent graph queries to keep utilization high; :class:`StealRegistry` is
the decentralized analogue for this runtime.

Protocol:

  * a :class:`~.scheduler.ScheduleRun` started with ``stealable=True``
    publishes itself here for the duration of its iteration; its
    *stealable backlog* is the undispatched package range behind the victim
    fence, and is only non-zero once the run is grinding in (or committed
    to) sequential execution — a healthy parallel run keeps its packages;
  * a session with idle capacity (drained of its own queries, or between
    queries while the pool has spare workers) picks a victim and claims
    trailing packages via :meth:`~.scheduler.ScheduleRun.donate`, which moves
    the fence down atomically so the claim can never race the victim's own
    ``next_step`` dispatch;
  * the thief executes the claimed packages through the *victim's* executor
    and signals :meth:`~.scheduler.ScheduleRun.donation_done`; the victim's
    iteration is not accounted until every donation has returned.

Victim selection is locality- and priority-aware: prefer victims running on
the thief's graph (the Q-Graph co-location argument — the thief's devices
already hold that graph's arrays), then higher-priority victims, then the
largest backlog. Ties keep the earliest-published victim, so selection is
deterministic.

Graph identity is *stable*, not object identity: :func:`graph_identity`
returns the graph's construction-time ``key`` (name + stats fingerprint), so
two sessions that loaded the same dataset into distinct objects still group
as same-graph — both for the thief's locality preference here and for gang
fusion's co-scheduling. (Keying by ``id(graph)`` silently disabled both
whenever sessions did not literally share one object.)

Fused gangs participate too: a :class:`~.fusion.FusionGroup` driver (a
negative-sid synthetic scheduling entity, never a query) publishes its fused
run with ``fused=True``; thieves claim trailing *fused* ids over the same
fence and the engine splits the claim back per member before executing it.
Fused runs publish *eagerly* (``ScheduleRun(eager_backlog=True)``): their
backlog is claimable whenever free capacity cannot raise the gang's usable
power-of-two width, not only when the gang grinds or is width-capped —
a gang carries several sessions' packages, so idle workers are better spent
on a thief's second gang than parked until the gang drains.

Thief gangs are *sized* in two steps: :meth:`StealRegistry.steal_budget`
bounds the request by governed availability (reserve floor honoured, zero
while a shrink's grant debt drains), and — with the §4.4 width-keyed
feedback table active — :meth:`StealRegistry.thief_gang_width` picks the
power-of-two width inside that budget that maximizes *measured* width
efficiency, instead of blindly requesting the victim's ``T_max``: a thief
has no obligation to reproduce a width that measured poorly.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any, Hashable, Iterator

from .scheduler import ScheduleRun, WorkerPool

if TYPE_CHECKING:  # pragma: no cover - annotation-only import
    from .feedback import CostFeedback


def graph_identity(executor: Any) -> Hashable:
    """Stable same-graph key for an executor: the graph's ``key`` property
    (dataset identity survives separate loads), falling back to object
    identity for graph-like objects without one, and ``None`` when the
    executor carries no graph at all."""
    g = getattr(executor, "graph", None)
    if g is None:
        return None
    key = getattr(g, "key", None)
    return key if key is not None else id(g)


@dataclasses.dataclass
class StealEntry:
    """One published victim: a session's active stealable run."""

    key: Hashable              # victim session id
    run: ScheduleRun
    priority: int = 0
    graph_key: Hashable = None  # identity of the graph the run traverses
    payload: Any = None         # opaque engine-side state (session record)
    fused: bool = False         # run is a fused gang (multi-session victim)
    # algorithm name of the victim's query (gang members share one): the key
    # thieves use to look up measured width efficiency when sizing their gang
    algorithm: str | None = None
    # distinct member algorithms of a *heterogeneous* scan-shared gang
    # (``algorithm`` stays None there — no single name covers the run);
    # thieves combine the tags of the claimable tail with this to size a
    # mixed-body gang (:meth:`StealRegistry.thief_gang_width_mixed`)
    algorithms: tuple[str, ...] = ()
    # locality domain the victim's run is placed on (None = single-domain
    # pool); thieves prefer same-domain victims and pay the contention
    # model's migration penalty when they reach across
    domain: int | None = None

    @property
    def backlog(self) -> int:
        """Packages a thief could claim from this victim right now."""
        return self.run.stealable_backlog


class StealRegistry:
    """Where active runs publish their undispatched package ranges.

    Deliberately decentralized (like the §4.3 scheduler itself): the registry
    holds no scheduling logic beyond victim ranking — fences and donation
    accounting live on the runs, so no central component needs to understand
    query internals."""

    def __init__(self) -> None:
        self._entries: dict[Hashable, StealEntry] = {}

    def publish(
        self,
        key: Hashable,
        run: ScheduleRun,
        *,
        priority: int = 0,
        graph_key: Hashable = None,
        payload: Any = None,
        fused: bool = False,
        algorithm: str | None = None,
        domain: int | None = None,
        algorithms: tuple[str, ...] = (),
    ) -> StealEntry:
        """Register ``run`` as a claimable victim under ``key`` (replacing
        any previous entry for that key); returns the live entry."""
        entry = StealEntry(
            key=key,
            run=run,
            priority=priority,
            graph_key=graph_key,
            payload=payload,
            fused=fused,
            algorithm=algorithm,
            domain=domain,
            algorithms=algorithms,
        )
        self._entries[key] = entry
        return entry

    def withdraw(self, key: Hashable) -> None:
        """Remove ``key``'s entry (iteration over, or victim retired)."""
        self._entries.pop(key, None)

    def entry(self, key: Hashable) -> StealEntry | None:
        """The live entry published under ``key``, or ``None``."""
        return self._entries.get(key)

    def __len__(self) -> int:
        return len(self._entries)

    def __iter__(self) -> Iterator[StealEntry]:
        return iter(self._entries.values())

    def total_backlog(self) -> int:
        """Claimable packages across every published victim."""
        return sum(e.backlog for e in self._entries.values())

    @staticmethod
    def steal_budget(pool: WorkerPool, *, priority: int = 0) -> int:
        """Workers a thief's second gang may take right now under the
        *governed* capacity: the pool's derived availability past the reserve
        floor for the steal's priority class, and zero while a shrink's grant
        debt is draining (the machine is already over-committed — launching a
        second gang would deepen the overhang the shrink is waiting out).
        Thieves must size their requests from this, never from the raw ``P``
        a victim's bounds were prepared against: under an elastic governor
        the capacity at claim time is not the capacity at preparation time."""
        if pool.shrink_debt > 0:
            return 0
        floor = 0 if priority >= 1 else pool.high_priority_reserve
        return max(pool.available - floor, 0)

    @staticmethod
    def thief_gang_width(
        feedback: "CostFeedback",
        algorithm: str,
        t_max: int,
        budget: int,
    ) -> int:
        """Size a thief gang from *measured* width efficiency.

        Among power-of-two widths ``w ≤ min(t_max, budget)``, pick the one
        maximizing ``w / width_ratio(algorithm, w)`` — the corrected
        throughput of a ``w``-wide gang relative to the algorithm's mode
        average (ideal scaling divided by how much worse width ``w``
        measured). With a cold table every ratio is 1.0 and the maximal
        power of two inside the budget wins, matching the raw
        ``min(T_max, steal_budget)`` request rounded to its usable width.
        Returns 0 when the budget admits no worker at all."""
        cap = min(max(int(t_max), 1), int(budget))
        if cap < 1:
            return 0
        best_w, best_eff = 0, 0.0
        w = 1
        while w <= cap:
            eff = w / feedback.width_ratio(algorithm, w)
            if eff > best_eff:
                best_w, best_eff = w, eff
            w <<= 1
        return best_w

    @staticmethod
    def thief_gang_width_mixed(
        feedback: "CostFeedback",
        algorithms: list[str] | tuple[str, ...],
        t_max: int,
        budget: int,
    ) -> int:
        """:meth:`thief_gang_width` for a *mixed* claim off a heterogeneous
        fused victim: the stolen tail interleaves several algorithms, so
        each candidate width is scored by ``w`` over the **mean** of the
        member algorithms' width ratios — the thief's one gang runs every
        compute body in turn, so its effective efficiency at width ``w`` is
        the blend, not any single table row. One algorithm degenerates to
        :meth:`thief_gang_width` exactly; an empty list falls back to ratio
        1.0 everywhere (the cold-table maximal power of two)."""
        names = list(algorithms)
        if len(names) == 1:
            return StealRegistry.thief_gang_width(
                feedback, names[0], t_max, budget
            )
        cap = min(max(int(t_max), 1), int(budget))
        if cap < 1:
            return 0
        best_w, best_eff = 0, 0.0
        w = 1
        while w <= cap:
            if names:
                ratio = sum(feedback.width_ratio(a, w) for a in names) / len(names)
            else:
                ratio = 1.0
            eff = w / ratio
            if eff > best_eff:
                best_w, best_eff = w, eff
            w <<= 1
        return best_w

    def pick_victim(
        self,
        *,
        thief_key: Hashable = None,
        graph_key: Hashable = None,
        min_backlog: int = 1,
        exclude: "set[Hashable] | None" = None,
        domain: int | None = None,
    ) -> StealEntry | None:
        """Rank victims: same-domain first (a cross-domain claim pays the
        contention model's migration penalty), then same-graph (locality),
        then priority (help the latency-sensitive query first), then the
        most backlogged. A thief with ``domain=None`` (single-domain pool)
        ranks exactly as before domains existed. Returns ``None`` when
        nothing claimable is published. ``exclude`` skips keys a thief
        already tried and found unusable this round."""
        best: StealEntry | None = None
        best_rank: tuple[bool, bool, int, int] | None = None
        for e in self._entries.values():
            if e.key == thief_key or (exclude is not None and e.key in exclude):
                continue
            backlog = e.backlog
            if backlog < min_backlog:
                continue
            rank = (
                domain is not None and e.domain == domain,
                graph_key is not None and e.graph_key == graph_key,
                e.priority,
                backlog,
            )
            if best_rank is None or rank > best_rank:
                best, best_rank = e, rank
        return best
