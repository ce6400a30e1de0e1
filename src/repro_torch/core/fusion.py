"""Gang fusion: co-schedule same-graph sessions as one wide gang (ROADMAP
top item).

The multi-query engine derives parallelization constraints *per query*, so N
concurrent sessions running the same algorithm on the same graph are
scheduled as N independent gangs — N grant requests, N preparation passes,
and N per-iteration gang launches, even though they traverse identical
topology. Query-locality systems (Q-Graph, arXiv:1805.11900; the two-level
concurrent scheduler of arXiv:1806.00777) co-locate such queries instead;
:class:`FusionGroup` is the analogue for this runtime.

Protocol (driven by ``run_sessions(config=EngineConfig(fuse=True))``):

  * a session reaching an iteration boundary with a parallel-worthy plan
    *stages* itself under ``(graph_key, algorithm, domain)`` — the domain is
    ``None`` on a single-domain pool — instead of starting its own
    :class:`~.scheduler.ScheduleRun`; the first stager arms a flush event
    ``hold_ns`` later (the gang-formation rendezvous — 0 by default, which
    still catches the common case of sessions synchronized by arrival or by
    a previous fused iteration);
  * at the flush, if ≥ 2 sessions staged and their summed ``T_max`` exceeds
    the pool capacity (none of them could be granted its full width alongside
    the others anyway), they fuse: one :class:`FusionGroup` interleaves the
    members' package lists round-robin into a single fused id space, one
    ``ScheduleRun`` executes it under one grant whose width is the capped sum
    of the members' ``T_max`` — otherwise everyone proceeds solo, unchanged;
  * every dispatched fused batch is split back per member
    (:meth:`FusionGroup.split`): the member's executor runs its own package
    ids, and per-member modeled/measured time, trace entries and
    ``fused_packages`` counters accumulate on the member — ``EngineReport``
    stays per-session truthful;
  * the gang launch overhead (``C_T_overhead·T + C_para_startup`` per
    iteration in the cost model) is charged **once** for the fused run and
    split across members pro rata — this is the modeled substance of fusion:
    one gang spin-up serves N iterations instead of N;
  * fused runs keep the full §4.3 machinery: the victim fence makes them
    stealable and preemptible at package boundaries. They publish their
    steal backlog *eagerly* (``ScheduleRun(eager_backlog=True)``): whenever
    the pool's free capacity cannot raise the gang's usable power-of-two
    width, trailing fused slots are claimable by a thief's second gang —
    a gang carries several sessions' packages, so parking idle workers
    until it drains wastes more than a steal round-trip costs;
  * the gang is *driven* by a synthetic session state with a **negative
    sid** — a scheduling entity, never a query, so it never appears in
    ``EngineReport.records``. Drivers are visible to the capacity governor
    like any run (their priority is the max of the members'), and a landed
    governor fence **de-fuses** the gang: each member resumes independently
    over its residual package ids (parked, so the freed workers go to the
    high-priority session the fence served first), exactly like a preempted
    solo run (§4.3's package boundary is the preemption point). A member
    whose packages drain early leaves the gang at the next package boundary
    while the rest keep running;
  * with the §4.4 feedback loop active (``run_sessions(width_feedback=
    True)`` and a :class:`~.feedback.CostFeedback` installed), the flush
    replaces the capped-T_max-sum width choice with
    :func:`plan_gang_width`: one :func:`~.bounds.thread_bounds` call on the
    *aggregated* :class:`~.cost_model.IterationWork` of the members, with
    each candidate width scored by the table's measured width ratio — so a
    gang narrows when wide execution measured poorly and the spared workers
    stay available to co-running classes.

The group holds no engine state beyond opaque ``payload`` handles, mirroring
the deliberately decentralized :class:`~.stealing.StealRegistry`.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Any

import numpy as np

from .bounds import ThreadBounds, thread_bounds
from .contention import HardwareModel
from .cost_model import IterationWork, c_vertex_total
from .descriptors import AlgorithmDescriptor
from .scheduler import PackageRun, ScheduleTrace

if TYPE_CHECKING:  # pragma: no cover - annotation-only import
    from .feedback import CostFeedback


@dataclasses.dataclass(frozen=True)
class FusionConfig:
    """Knobs for gang formation.

    ``hold_ns`` is the rendezvous window on the modeled clock: the first
    session staging under a key waits this long for co-arrivals before the
    flush decides fuse-vs-solo. 0 fuses only sessions that reach an iteration
    boundary at the same modeled instant (burst arrivals, members released
    together by a previous fused iteration); a small positive hold also
    catches stragglers at the cost of added latency. ``max_members`` caps the
    gang width so a huge burst forms several gangs instead of one unbounded
    one (groups are cut FIFO in staging order)."""

    hold_ns: float = 0.0
    max_members: int = 8

    def __post_init__(self) -> None:
        if self.hold_ns < 0:
            raise ValueError("hold_ns must be >= 0")
        if self.max_members < 2:
            raise ValueError("max_members must be >= 2")


@dataclasses.dataclass(frozen=True)
class FusedPackages:
    """Duck-typed :class:`~.packaging.WorkPackages` stand-in for the fused id
    space: fused id *i* is the *i*-th slot of the round-robin interleave of
    the members' package orders. Only the surface :class:`ScheduleRun` reads
    (``order``/``n_packages``) exists — executors never see fused ids, the
    group splits every batch back to member-local ids first.

    ``tags`` (heterogeneous gangs) carries the *algorithm name per fused
    slot*: the interleaved package table of a scan-shared gang mixes
    packages of different algorithms, and downstream consumers — a thief
    sizing its gang against the claimable tail, the de-fuse handover — need
    to know which compute body each slot belongs to without consulting the
    group. ``None`` on homogeneous gangs (every slot is the one algorithm
    the rendezvous key carried)."""

    order: np.ndarray
    n_packages: int
    tags: np.ndarray | None = None


@dataclasses.dataclass
class FusionMember:
    """One session's share of a fused gang.

    ``order`` is the member's own package order; ``covered[k]`` flips when
    position *k* has been dispatched by a committed gang step or donated to a
    thief, so ``residual()`` (the de-fuse handover) and completion checks are
    exact. Costs and trace entries accumulate here and are booked into the
    member's ``QueryRecord`` when the member leaves the gang."""

    payload: Any                 # engine-side session state (opaque)
    prep: Any                    # the member's PreparedIteration
    bounds: ThreadBounds         # the member's own solo bounds
    order: np.ndarray            # member-local package ids, member's order
    covered: np.ndarray          # [n] bool per position
    trace: ScheduleTrace
    pending_stolen: int = 0      # donated batches not yet returned
    modeled_ns: float = 0.0
    measured_ns: float = 0.0
    finished: bool = False       # iteration accounted, member left the gang
    defused: bool = False        # gang dissolved; member runs its residual
    # algorithm name of the member's query — always the gang's one algorithm
    # on a homogeneous gang, per-member on a heterogeneous scan-shared gang
    # (None when the caller did not tag members; split-back still resolves
    # the compute body through ``payload``)
    algorithm: str | None = None

    @property
    def n_packages(self) -> int:
        """Number of packages this member contributed to the gang."""
        return int(self.order.size)

    @property
    def complete(self) -> bool:
        """Every position dispatched-and-committed or returned by a thief."""
        return (
            not self.finished
            and bool(self.covered.all())
            and self.pending_stolen == 0
        )


class FusionGroup:
    """The fused iteration of ≥ 2 same-graph sessions.

    Homogeneous gangs carry one algorithm — the rendezvous key
    included it. A *heterogeneous scan-shared* gang (``scan_shared=True``)
    fuses sessions of **different** algorithms on the same graph/domain: one
    interleaved package table, one grant, one topology traversal per fused
    step, with each member's own compute body applied to its share of the
    shared scan (the split-back machinery is algorithm-agnostic already —
    every share executes through its member's executor)."""

    def __init__(
        self,
        members: list[FusionMember],
        member_of: np.ndarray,
        pos_of: np.ndarray,
        bounds: ThreadBounds,
        domain: int | None = None,
        scan_shared: bool = False,
    ):
        self.members = members
        self._member_of = member_of   # [n_fused] member index per fused id
        self._pos_of = pos_of         # [n_fused] member-local position
        self.bounds = bounds
        # locality domain of the whole gang: the rendezvous key includes the
        # members' placement, so a gang never straddles a domain boundary and
        # its single grant draws from one domain's share
        self.domain = domain
        # heterogeneous topology sharing: members of different algorithms
        # ride one CSR traversal per fused step — the modeled edge-stream
        # cost is charged once per step, not once per member
        self.scan_shared = bool(scan_shared)
        self.n_packages = int(member_of.size)
        tags = None
        if any(m.algorithm is not None for m in members):
            # per-fused-slot algorithm tags: carried by the interleaved
            # package table so the scheduler/steal path can reason about
            # which compute body a slot belongs to without the group
            names = [m.algorithm or "" for m in members]
            tags = np.asarray([names[int(i)] for i in member_of])
        self.packages = FusedPackages(
            order=np.arange(self.n_packages, dtype=np.int64),
            n_packages=self.n_packages,
            tags=tags,
        )

    @property
    def algorithms(self) -> list[str]:
        """Distinct member algorithms, first-member order (one entry on a
        homogeneous gang, several on a scan-shared heterogeneous one)."""
        seen: list[str] = []
        for m in self.members:
            if m.algorithm is not None and m.algorithm not in seen:
                seen.append(m.algorithm)
        return seen

    @property
    def heterogeneous(self) -> bool:
        """True when members run more than one distinct algorithm."""
        return len(self.algorithms) > 1

    def member_groups(self) -> dict[str, list[FusionMember]]:
        """Members keyed by algorithm (the per-algorithm member groups a
        heterogeneous gang de-fuses back into)."""
        groups: dict[str, list[FusionMember]] = {}
        for m in self.members:
            groups.setdefault(m.algorithm or "", []).append(m)
        return groups

    @classmethod
    def build(
        cls,
        staged: list[tuple[Any, Any, ThreadBounds]],
        *,
        capacity: int,
        gang_width: int | None = None,
        domain: int | None = None,
        algorithms: list[str] | None = None,
        scan_shared: bool = False,
    ) -> "FusionGroup":
        """Fuse ``(payload, prep, bounds)`` triples into one group.

        The fused order interleaves member package lists round-robin (each in
        its member's own, possibly heavy-first, order) so the gang drains all
        members together and an uneven member finishes early instead of
        serializing member-after-member. The fused width request defaults to
        the members' summed ``T_max`` capped at the pool capacity — one grant
        request for the whole gang; ``gang_width`` (from
        :func:`plan_gang_width`'s measured-width sweep) overrides it, still
        clamped to ``[t_min, capacity]``.

        ``algorithms`` tags each staged member with its algorithm name
        (parallel to ``staged``); ``scan_shared=True`` marks the gang as a
        heterogeneous topology-sharing gang whose members charge the CSR
        edge scan once per fused step (:func:`apply_scan_sharing`). Both
        default to the homogeneous behavior."""
        members: list[FusionMember] = []
        for i, (payload, prep, bounds) in enumerate(staged):
            pkgs = prep.packages
            order = np.asarray(pkgs.order[: pkgs.n_packages], dtype=np.int64)
            members.append(
                FusionMember(
                    payload=payload,
                    prep=prep,
                    bounds=bounds,
                    order=order,
                    covered=np.zeros(order.size, dtype=bool),
                    trace=ScheduleTrace(requested=0),
                    algorithm=algorithms[i] if algorithms is not None else None,
                )
            )
        member_of: list[int] = []
        pos_of: list[int] = []
        longest = max(m.n_packages for m in members)
        for r in range(longest):
            for i, m in enumerate(members):
                if r < m.n_packages:
                    member_of.append(i)
                    pos_of.append(r)
        if gang_width is not None:
            t_max = min(max(int(gang_width), 1), capacity)
        else:
            t_max = min(sum(max(m.bounds.t_max, 1) for m in members), capacity)
        t_min = min(max(m.bounds.t_min, 2) for m in members)
        fused_bounds = dataclasses.replace(
            members[0].bounds,
            parallel=True,
            t_min=t_min,
            t_max=max(t_max, t_min),
            n_packages=len(member_of),
            cost_seq_ns=sum(m.bounds.cost_seq_ns for m in members),
            cost_par_ns=sum(m.bounds.cost_par_ns for m in members),
        )
        for m in members:
            m.trace.requested = fused_bounds.t_max
        return cls(
            members,
            np.asarray(member_of, dtype=np.int64),
            np.asarray(pos_of, dtype=np.int64),
            fused_bounds,
            domain=domain,
            scan_shared=scan_shared,
        )

    # ------------------------------------------------------------- splitting
    def active(self) -> list[FusionMember]:
        """Members whose fused iteration has not been accounted yet."""
        return [m for m in self.members if not m.finished]

    def split(
        self, fused_ids: np.ndarray
    ) -> list[tuple[FusionMember, np.ndarray, np.ndarray]]:
        """Map a fused batch back to ``(member, positions, local_ids)``
        shares, preserving dispatch order within each member."""
        out = []
        midx = self._member_of[fused_ids]
        for i in np.unique(midx):
            sel = fused_ids[midx == i]
            positions = self._pos_of[sel]
            member = self.members[int(i)]
            out.append((member, positions, member.order[positions]))
        return out

    # ------------------------------------------------------------ accounting
    def commit_step(
        self,
        member: FusionMember,
        positions: np.ndarray,
        local_ids: np.ndarray,
        mode: str,
        workers: int,
        modeled_ns: float,
        measured_ns: float,
    ) -> None:
        """Book one completed gang-step share into the member (split-back)."""
        member.covered[positions] = True
        member.modeled_ns += modeled_ns
        member.measured_ns += measured_ns
        member.trace.runs.extend(
            PackageRun(int(p), mode, workers) for p in local_ids
        )
        member.trace.fused_packages += int(local_ids.size)

    def mark_donated(
        self,
        member: FusionMember,
        positions: np.ndarray,
        local_ids: np.ndarray,
        workers: int,
    ) -> None:
        """A thief claimed these positions over the fused run's fence."""
        member.covered[positions] = True
        member.pending_stolen += 1
        member.trace.stolen_packages += int(local_ids.size)
        member.trace.runs.extend(
            PackageRun(int(p), "stolen", workers) for p in local_ids
        )

    def account_stolen(
        self, member: FusionMember, modeled_ns: float, measured_ns: float
    ) -> None:
        """A donated batch returned: book its time, release the join hold."""
        member.modeled_ns += modeled_ns
        member.measured_ns += measured_ns
        member.pending_stolen = max(member.pending_stolen - 1, 0)

    def residual(self, member: FusionMember) -> np.ndarray:
        """Member-local package ids not yet dispatched or donated — the
        de-fuse handover, in the member's original order."""
        return member.order[~member.covered]


# ---------------------------------------------------------------- cost split
def member_work_ns(
    desc: AlgorithmDescriptor,
    hw: HardwareModel,
    work: Any,
    t: int,
    fraction: float,
) -> float:
    """Work-only modeled time of a member's share of one gang step: the
    iteration cost at width ``t`` *without* the per-iteration launch terms
    (those are charged once per gang step via :func:`gang_overhead_ns`)."""
    cv = c_vertex_total(desc, hw, work, t)
    total = work.frontier * cv
    if t > 1:
        total /= t
    return total * fraction


def member_scan_ns(
    desc: AlgorithmDescriptor,
    hw: HardwareModel,
    work: Any,
    t: int,
    fraction: float,
) -> float:
    """The topology-streaming slice of a member's share of one gang step:
    the plain-memory portion of the edge term in Eq. (8) — the CSR
    adjacency/offset loads every algorithm performs identically when it
    walks the frontier's out-edges. This is the cost a heterogeneous
    scan-shared gang pays once per fused step instead of once per member
    (:func:`apply_scan_sharing`). Atomics and op terms stay per-member:
    those are the algorithm's *compute body* on the shared scan.

    Structurally a strict lower bound on :func:`member_work_ns` for any
    descriptor with nonzero vertex/compute terms — the discount can never
    drive a member's share negative."""
    s = max(work.frontier, 1.0)
    epv = work.edges / s
    scan = work.frontier * epv * desc.e.n_mem * hw.l_mem(work.m_bytes)
    if t > 1:
        scan /= t
    return scan * fraction


def apply_scan_sharing(shares_ns: list[float], scans_ns: list[float]) -> list[float]:
    """Discount per-member gang-step shares so the shared topology scan is
    charged once across the gang instead of once per member.

    ``shares_ns[i]`` is member *i*'s full modeled share of the fused step
    (:func:`member_work_ns`, remote factor included); ``scans_ns[i]`` is the
    scan slice inside it (:func:`member_scan_ns`, same factors). The gang
    pays ``max(scans_ns)`` — the widest member's traversal covers everyone
    riding it — so the savings ``Σ scan − max(scan)`` are subtracted from the
    members pro rata to their scan share. Conservation is exact:
    ``Σ adjusted == Σ shares − savings`` (the property the split-back tests
    pin down), and every adjusted share stays ≥ its compute-only part."""
    if len(shares_ns) <= 1:
        return list(shares_ns)
    total_scan = sum(scans_ns)
    if total_scan <= 0.0:
        return list(shares_ns)
    savings = total_scan - max(scans_ns)
    if savings <= 0.0:
        return list(shares_ns)
    return [
        share - savings * (scan / total_scan)
        for share, scan in zip(shares_ns, scans_ns)
    ]


def plan_hetero_gang_width(
    staged: list[tuple[Any, Any, ThreadBounds]],
    descs: list[AlgorithmDescriptor],
    hw: HardwareModel,
    *,
    capacity: int,
    feedback: "CostFeedback | None" = None,
) -> int:
    """Measured-width planning for a *heterogeneous* gang: score the
    combined per-algorithm :class:`~.cost_model.IterationWork` with **each
    member algorithm's own** width correction.

    ``descs`` is parallel to ``staged``. Members are grouped by algorithm;
    each group's work aggregates (:func:`aggregate_work`) and a power-of-two
    sweep scores every candidate width by the *sum* of per-algorithm
    corrected compute costs plus the once-per-gang launch overhead — the
    argmin over corrected cost wins. When any algorithm's width entry is
    censored at a candidate (:meth:`~.feedback.CostFeedback.width_censored`
    — its measured ratios clipped so hard the table distrusts them), the
    sweep is abandoned and the gang falls back to the **most conservative
    member**: the smallest of the per-algorithm pure-model preferred widths,
    so an algorithm with unreadable feedback never drags the others wide.
    Degenerate single-algorithm input delegates to :func:`plan_gang_width`
    (byte-identical homogeneous behavior)."""
    by_algo: dict[str, list[int]] = {}
    for i, d in enumerate(descs):
        by_algo.setdefault(d.name, []).append(i)
    if len(by_algo) == 1:
        return plan_gang_width(
            staged, descs[0], hw, capacity=capacity, feedback=feedback
        )
    capped_sum = min(sum(max(b.t_max, 1) for _, _, b in staged), capacity)
    groups = []  # (desc, aggregate work) per algorithm
    for name, idxs in by_algo.items():
        agg = aggregate_work([staged[i][1].work for i in idxs])
        groups.append((descs[idxs[0]], agg))

    def pure_cost(desc: AlgorithmDescriptor, agg: IterationWork, t: int) -> float:
        return max(agg.frontier, 1.0) * c_vertex_total(desc, hw, agg, t) / t

    def preferred_pure_width(desc: AlgorithmDescriptor, agg: IterationWork) -> int:
        best_t, best_cost = 2, float("inf")
        t = 2
        while t <= capped_sum:
            cost = (
                pure_cost(desc, agg, t)
                + hw.c_thread_overhead_ns * t
                + hw.c_para_startup_ns
            )
            if cost < best_cost:
                best_t, best_cost = t, cost
            t <<= 1
        return best_t

    if feedback is not None:
        censored = False
        t = 2
        while t <= capped_sum and not censored:
            censored = any(
                feedback.width_censored(desc.name, t) for desc, _ in groups
            )
            t <<= 1
        if censored:
            # most conservative member: an algorithm whose differential
            # width signal is unreadable must not be run wider than its own
            # pure model would pick, and neither should the gang it rides in
            return max(
                min(preferred_pure_width(desc, agg) for desc, agg in groups), 2
            )
    best_t, best_cost = None, float("inf")
    t = 2
    while t <= capped_sum:
        cost = hw.c_thread_overhead_ns * t + hw.c_para_startup_ns
        for desc, agg in groups:
            ratio = (
                feedback.width_ratio(desc.name, t)
                if feedback is not None
                else 1.0
            )
            cost += pure_cost(desc, agg, t) * ratio
        if cost < best_cost:
            best_t, best_cost = t, cost
        t <<= 1
    if best_t is None:
        return max(capped_sum, 2)
    return max(best_t, 2)


def gang_overhead_ns(hw: HardwareModel, t: int, k: int, n_fused: int) -> float:
    """The gang launch overhead slice for a fused step of ``k`` of
    ``n_fused`` packages at width ``t``: ``C_T_overhead·T + C_para_startup``
    charged once for the whole fused iteration — N members share one gang
    spin-up instead of paying one each. Sequential grinding (t ≤ 1) carries
    no launch overhead, fused or not."""
    if t <= 1 or n_fused <= 0:
        return 0.0
    return (hw.c_thread_overhead_ns * t + hw.c_para_startup_ns) * (k / n_fused)


def aggregate_work(works: list[IterationWork]) -> IterationWork:
    """Sum member iteration-work profiles into the gang's aggregate: the
    fused run traverses every member's frontier/edges in one iteration, so
    the aggregate is a plain componentwise sum (shared-memory footprint
    included — the members' counter arrays are distinct even on one graph)."""
    return IterationWork(
        frontier=sum(w.frontier for w in works),
        edges=sum(w.edges for w in works),
        found=sum(w.found for w in works),
        touched=sum(w.touched for w in works),
        m_bytes=sum(w.m_bytes for w in works),
    )


def plan_gang_width(
    staged: list[tuple[Any, Any, ThreadBounds]],
    desc: AlgorithmDescriptor,
    hw: HardwareModel,
    *,
    capacity: int,
    feedback: "CostFeedback | None" = None,
) -> int:
    """Measured-width gang planning (replaces the capped-T_max-sum choice).

    One :func:`~.bounds.thread_bounds` call on the *aggregated*
    :class:`~.cost_model.IterationWork` of the staged members — with each
    candidate width's modeled cost scaled by the feedback table's measured
    width ratio (:meth:`~.feedback.CostFeedback.width_ratio`) — yields the
    valid width range ``[T_min, T_max]`` for the gang as a whole. The
    candidates inside that range are then *scored* by corrected gang
    iteration cost (compute at the measured width ratio plus the one-per-gang
    launch overhead) and the cheapest width wins: Algorithm 1's ``T_max`` is
    only the widest width still profitable *versus sequential*, while a gang
    should run at the width that is cheapest *among the profitable ones* —
    when wide execution measured poorly, the gang narrows and the spared
    workers stay available to co-running classes (the mixed-burst regime
    where independent narrow gangs beat one maximal gang).

    The result is clamped to the homogeneous gangs' capped-T_max-sum (never request more
    parallelism than the members' own bounds justify together) and never
    below 2. With a cold table every width ratio is 1.0 and the sweep is the
    plain cost model on the aggregate."""
    capped_sum = min(sum(max(b.t_max, 1) for _, _, b in staged), capacity)
    width_correction = None
    if feedback is not None:
        width_correction = lambda t: feedback.width_ratio(desc.name, t)  # noqa: E731
    agg = aggregate_work([prep.work for _, prep, _ in staged])
    tb = thread_bounds(desc, hw, agg, p=capacity, width_correction=width_correction)
    if not tb.parallel:
        # the corrected sweep found no profitable width on the aggregate —
        # fall back to the members' own summed bounds rather than fusing a
        # gang the plan says should not exist (should_fuse gated it already)
        return max(capped_sum, 2)
    v = max(agg.frontier, 1.0)
    best_t, best_cost = None, float("inf")
    t = max(tb.t_min, 2)
    while t <= min(tb.t_max, capped_sum):
        ratio = width_correction(t) if width_correction is not None else 1.0
        cost = (
            v * c_vertex_total(desc, hw, agg, t) * ratio / t
            + hw.c_thread_overhead_ns * t
            + hw.c_para_startup_ns
        )
        if cost < best_cost:
            best_t, best_cost = t, cost
        t <<= 1
    if best_t is None:
        return max(min(tb.t_max, capped_sum), 2)
    return max(best_t, 2)


def should_fuse(
    staged: list[tuple[Any, Any, ThreadBounds]], *, capacity: int
) -> bool:
    """Fuse only when the members' summed ``T_max`` exceeds the pool
    capacity: below that, every staged session can be granted its full width
    side by side and independent narrow gangs are at least as good — fusing
    would serialize work that could overlap."""
    if len(staged) < 2:
        return False
    return sum(max(b.t_max, 1) for _, _, b in staged) > capacity


def merge_member_trace(fused: ScheduleTrace, solo: ScheduleTrace) -> ScheduleTrace:
    """Join a member's fused-iteration share with its post-de-fuse residual
    run into the single per-iteration trace the record keeps."""
    return ScheduleTrace(
        requested=max(fused.requested, solo.requested),
        runs=fused.runs + solo.runs,
        released_early=solo.released_early,
        stolen_packages=fused.stolen_packages + solo.stolen_packages,
        preempted=fused.preempted + solo.preempted,
        fused_packages=fused.fused_packages,
    )


__all__ = [
    "FusedPackages",
    "FusionConfig",
    "FusionGroup",
    "FusionMember",
    "aggregate_work",
    "apply_scan_sharing",
    "gang_overhead_ns",
    "member_scan_ns",
    "member_work_ns",
    "merge_member_trace",
    "plan_gang_width",
    "plan_hetero_gang_width",
    "should_fuse",
]
