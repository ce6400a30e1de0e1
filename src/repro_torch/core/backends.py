"""Pluggable execution substrate: where a schedule step's packages run.

The engine dispatches every :class:`ScheduleStep` through this seam onto one
of three substrates:

* :class:`ModeledBackend` (the default) — the query's compute still runs
  (executor state must advance: frontiers, convergence, edge counts), but
  nothing is wall-clock timed; ``execute`` *echoes the modeled step cost*
  as the measurement. The run is fully deterministic and the §4.4 feedback
  loop sees ratio-1.0 observations, i.e. the correction tables stay exactly
  neutral.
* :class:`InlineBackend` — the timed path: ``run_packages`` wrapped in
  ``perf_counter_ns`` (with a CUDA synchronize before the end stamp when
  the executor's tensors live on the card). Real measurements flow into the
  feedback tables.
* :class:`CudaBackend` — lowers a package batch to the hand-written SpMV /
  degree-count CUDA kernels (``kernels/spmv``, ``kernels/degree_count``;
  their plain PyTorch versions when the executor's tensors lie on the CPU).
  Each merged package range is one launch, at any gang width: on one
  stream, launches run one after another, and within one launch the
  kernel's blocks already spread over the SMs, so a launch per gang member
  would add host work and no parallelism. BFS goes further: its sweep
  reads every edge whatever the frontier, so a level's first range
  expands the whole frontier in one launch and the level's other ranges
  only do their bookkeeping. The gang width sets the modeled
  cost, Algorithm 1's bounds, packaging and stealing, and its measured
  nanoseconds flow into the feedback tables; it does not set the launch
  count. Package ranges are widened to tile boundaries and the
  out-of-range lanes masked off before the result is applied (unpadding),
  so results stay exact. Algorithms without a kernel lowering (PR-push,
  direction-optimized BFS) run the inline path.

The protocol splits *preparation* from *execution* deliberately:
``prepare`` may build kernels, stage device tile tables and warm them;
``execute`` measures steady-state kernel time only. The engine never times
``prepare``, so a build cannot pollute the width-feedback EWMA's first
observation.
"""
from __future__ import annotations

import dataclasses
import time
from typing import TYPE_CHECKING, Any, Protocol, runtime_checkable

import numpy as np
import torch

from . import tracing
from ..kernels.spmv.spmv import DST_TILE

if TYPE_CHECKING:  # pragma: no cover - annotation-only imports (no cycles)
    from .autotuner import PreparedIteration
    from .scheduler import ScheduleStep
    from .session import QueryExecutor

# plans memoized per backend, oldest evicted first. At most one prep is live
# per executor, but an engine loop that makes a new executor for every query
# fills the memo to this cap, and each plan keeps its executor, with the
# executor's device arrays, alive until it is evicted
_PLAN_CACHE_CAP = 256


@dataclasses.dataclass(frozen=True)
class DevicePlan:
    """Backend-prepared execution state for one (executor, prep, shard) key.

    ``handle`` is backend-private (device tile tables, prefix sums for
    unpadding); the engine only ever passes the plan back to the backend
    that built it. ``shard`` is the locality-domain
    :class:`~..graph.partition.GraphShard` the plan was staged against
    (``None`` on a single-domain pool)."""

    executor: "QueryExecutor"
    prep: "PreparedIteration"
    handle: Any = None
    shard: Any = None


@runtime_checkable
class ExecutionBackend(Protocol):
    """Where a schedule step's packages execute.

    ``prepare`` is called (and memoized) before the first ``execute`` of an
    (executor, prep) pair and may be arbitrarily slow — kernel builds and
    device staging belong here, *outside* any measured window. A
    multi-domain engine additionally passes the ``shard`` its placement
    chose; the backend memoizes one plan per (prep, shard) so dispatch can
    run against shard-local device state. ``execute`` runs one step's
    package batch at the granted width and returns the measured nanoseconds
    that flow into records and the §4.4 feedback tables. ``modeled_ns`` is
    the engine's modeled cost for the step — substrates that do no
    wall-clock timing echo it back."""

    name: str

    def prepare(
        self, executor: "QueryExecutor", prep: "PreparedIteration", shard: Any = None
    ) -> DevicePlan:
        """Stage one (executor, prep[, shard]) key for execution (build
        kernels, stage device tables, warm them); memoized per key."""
        ...

    def execute(
        self, plan: DevicePlan, step: "ScheduleStep", modeled_ns: float = 0.0
    ) -> float:
        """Run one step's package batch; returns measured ns."""
        ...


def _run_inline(plan: DevicePlan, step: "ScheduleStep") -> None:
    """The shared inline execution body: the executor's own compute."""
    parallel = step.mode == "parallel"
    plan.executor.run_packages(
        step.batch,
        plan.prep.packages,
        step.workers if parallel else 1,
        parallel=parallel,
    )


def _sync_if_cuda(executor: "QueryExecutor") -> None:
    """Wait for the executor's device work (the counterpart of
    ``jax.block_until_ready``) when its graph lives on the card."""
    g = getattr(executor, "graph", None)
    dev = getattr(g, "device", None)
    if dev is not None:
        tracing.host_read(dev)


class _PlanMemo:
    """Per-backend (executor, prep, shard) → DevicePlan memo.

    Keyed by object ids but holding strong references through the stored
    plans, so a key can never be reused while its entry is alive. ``shard``
    joins the key so a session whose placement drifts across domains gets
    one plan per shard it executes against, not a single clobbered slot.
    Evicts FIFO past the cap. At most one prep is live per executor, but a
    loop that makes new executors (one a query) reaches the cap, and the
    memo then holds the last 256 plans' executors alive."""

    def __init__(self) -> None:
        self._plans: dict[tuple[int, int, int], DevicePlan] = {}

    def get(
        self, executor: "QueryExecutor", prep: "PreparedIteration", shard: Any = None
    ) -> DevicePlan | None:
        """The memoized plan for this exact (executor, prep, shard) key."""
        return self._plans.get(
            (id(executor), id(prep), id(shard) if shard is not None else 0)
        )

    def put(self, plan: DevicePlan) -> DevicePlan:
        """Memoize ``plan``; evicts the oldest entry past the cap."""
        key = (
            id(plan.executor),
            id(plan.prep),
            id(plan.shard) if plan.shard is not None else 0,
        )
        self._plans[key] = plan
        while len(self._plans) > _PLAN_CACHE_CAP:
            self._plans.pop(next(iter(self._plans)))
        return plan


class ModeledBackend:
    """Default substrate: advance the query, trust the modeled clock.

    ``run_packages`` still executes (the query's semantics — frontier
    expansion, convergence, edge counts — live there), but no wall-clock
    measurement is taken: ``execute`` returns the step's *modeled* cost as
    the measured time. Every (modeled, measured) pair the feedback loop
    sees is therefore exactly ratio 1.0, keeping all correction tables at
    their neutral fixed point — scheduling decisions are byte-identical to
    an engine with no feedback installed, and fully host-independent."""

    name = "modeled"

    def __init__(self) -> None:
        self._memo = _PlanMemo()

    def prepare(
        self, executor: "QueryExecutor", prep: "PreparedIteration", shard: Any = None
    ) -> DevicePlan:
        """No device staging needed; returns a bare (executor, prep) plan."""
        plan = self._memo.get(executor, prep, shard)
        if plan is None:
            plan = self._memo.put(DevicePlan(executor, prep, shard=shard))
        return plan

    def execute(
        self, plan: DevicePlan, step: "ScheduleStep", modeled_ns: float = 0.0
    ) -> float:
        """Run the packages inline, echo the modeled cost as measured."""
        _run_inline(plan, step)
        return float(modeled_ns)


class InlineBackend:
    """The measured path: time ``run_packages`` on this host.

    PyTorch runs eagerly, so there is no compilation to pay inside the
    measured window; on the card the end stamp waits for the device."""

    name = "inline"

    def __init__(self) -> None:
        self._memo = _PlanMemo()

    def prepare(
        self, executor: "QueryExecutor", prep: "PreparedIteration", shard: Any = None
    ) -> DevicePlan:
        """No device staging needed; returns a bare (executor, prep) plan."""
        plan = self._memo.get(executor, prep, shard)
        if plan is None:
            plan = self._memo.put(DevicePlan(executor, prep, shard=shard))
        return plan

    def execute(
        self, plan: DevicePlan, step: "ScheduleStep", modeled_ns: float = 0.0
    ) -> float:
        """Run the packages inline and return real wall nanoseconds."""
        t0 = time.perf_counter_ns()
        _run_inline(plan, step)
        _sync_if_cuda(plan.executor)
        return float(time.perf_counter_ns() - t0)


# ---------------------------------------------------------------------------
# CUDA substrate
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _CudaHandle:
    """Device state one :class:`CudaBackend` plan executes against."""

    kind: str                      # "pr_pull" | "bfs" | "degree_count" | "inline"
    tables: Any = None             # SpmvTiles: ragged dst tiles (spmv kinds)
    num_vertices: int = 0
    edge_prefix: np.ndarray | None = None  # [V+1] in-edges with dst < v (pr_pull)
    ids: Any = None                # [2, E] int32 endpoint ids mod C (degree_count)
    # shard-local dispatch (locality domains): the plan's shard covers dst
    # tiles [tile_lo, tile_hi) and ``slab`` holds those tiles alone — ranges
    # inside it dispatch against the slab (what a domain's device would
    # actually hold), anything outside falls back to the full tables so
    # results stay exact when a frontier drifts off its placed shard
    tile_lo: int = 0
    tile_hi: int = 0
    slab: Any = None


class CudaBackend:
    """Dispatch package batches onto the hand-written CUDA graph kernels.

    Lowerings, each one kernel launch per merged package range whatever
    the step's gang width (BFS: one per level; see the module docstring
    for why, and for the padding/unpadding contract):

    * ``pagerank_pull`` — a package batch is a contiguous range of *target*
      vertices; the ragged dst-tile layout built by
      ``kernels/spmv/ops.build_tiles`` is sliced to the tiles covering the
      range, the SpMV kernel sums each target's in-edges, and lanes outside
      the range are masked off before the partial is applied to the
      executor's accumulator.
    * ``bfs_top_down`` — frontier expansion *is* an SpMV over the boolean
      semiring: contributions are the indicator of the whole frontier, the
      kernel counts per-target frontier parents over the dst-tiled
      out-edge list, and ``counts > 0 & ~visited`` is the level's found
      set. The level's first range sweeps; every later range of the level
      launches nothing (counters ``bfs.level_sweeps`` and
      ``bfs.ranges_served``).
    * ``degree_count`` — a package batch is an edge range; its endpoint ids
      (kept on the device, reduced mod the counter-array size) are
      histogrammed by ``kernels/degree_count`` straight into one
      device-resident counter tensor.

    Anything without a lowering (PR-push's unsorted scatter) runs the
    inline path — the backend is a superset, never a restriction.

    Kernels run where the executor's tensors are: the CUDA kernels for a
    graph on the card, their plain PyTorch versions for a graph the caller
    built on the CPU. ``execute`` synchronizes the device before its end
    stamp."""

    name = "cuda"

    def __init__(self) -> None:
        self._memo = _PlanMemo()
        # graph-level device state, shared by every plan on the same graph:
        # raw tile tables under (gkey, "in"|"out"), and *whole warmed
        # handles* under (gkey, kind, shard_key) — the topology is staged
        # and the kernel warmed once per (graph, shard), so N concurrent
        # sessions (same or different algorithms, scan-shared gangs
        # included) load it once, not once per prep
        self._graph_tables: dict[tuple, _CudaHandle] = {}

    def _handle_key(self, executor: "QueryExecutor", kind: str, gkey, shard) -> tuple | None:
        """Shared-handle cache key: everything the staged device state
        depends on besides the graph itself. ``None`` when the lowering has
        no shareable state (inline fallback) or the graph has no identity."""
        if gkey is None:
            return None
        if kind == "pr_pull":
            skey = (
                (int(shard.v_lo), int(shard.v_hi)) if shard is not None else None
            )
            return (gkey, kind, skey)
        if kind == "bfs":
            return (gkey, kind, None)
        if kind == "degree_count":
            # ids are reduced mod the counter-array size
            return (gkey, kind, int(executor.num_counters))
        return None

    # ------------------------------------------------------------ staging
    def _spmv_tables(self, key: tuple, src, dst, num_vertices: int):
        """Ragged dst-tile tables for one edge list, cached per graph+kind."""
        cached = self._graph_tables.get(key)
        if cached is not None:
            return cached.tables
        from ..kernels.spmv.ops import build_tiles

        with tracing.span("backend.stage"):
            tables = build_tiles(src, dst, num_vertices)
        self._graph_tables[key] = _CudaHandle(kind="tables", tables=tables)
        return tables

    def _warm_spmv(self, handle: _CudaHandle) -> None:
        """Build and load the kernel outside any measured window."""
        from ..kernels.spmv.ops import spmv_tiles

        tables = handle.tables
        contrib = torch.zeros(
            (handle.num_vertices,), dtype=torch.float32, device=tables.src.device
        )
        spmv_tiles(tables, contrib, 0, 1)
        tracing.host_read(contrib.device)

    def prepare(
        self, executor: "QueryExecutor", prep: "PreparedIteration", shard: Any = None
    ) -> DevicePlan:
        """Build (or reuse) device tile tables and warm the kernel; with a
        ``shard`` the pr_pull plan additionally stages the shard's dst-tile
        slab so dispatch against the placed domain touches only its slice."""
        plan = self._memo.get(executor, prep, shard)
        if plan is not None:
            return plan
        with tracing.span("backend.prepare"):
            return self._stage_plan(executor, prep, shard)

    def _stage_plan(
        self, executor: "QueryExecutor", prep: "PreparedIteration", shard: Any
    ) -> DevicePlan:
        """A new plan for :meth:`prepare`: the shared handle, or a staged
        and warmed one."""
        from .stealing import graph_identity

        gkey = graph_identity(executor)
        # executors opt into a kernel lowering explicitly (a subclass whose
        # run_packages carries extra semantics — direction-optimized BFS —
        # opts back out by clearing the attribute)
        kind = getattr(executor, "kernel_lowering", None)
        hkey = self._handle_key(executor, kind, gkey, shard) if kind else None
        if hkey is not None:
            shared = self._graph_tables.get(hkey)
            if shared is not None:
                # another session (or a previous prep of this one) already
                # staged and warmed this (graph, kind, shard) — reuse it
                return self._memo.put(
                    DevicePlan(executor, prep, shared, shard=shard)
                )
        handle: _CudaHandle
        if kind == "pr_pull":
            in_src, in_dst = executor.pull_edges()
            nv = int(executor.graph.num_vertices)
            tables = self._spmv_tables((gkey, "in"), in_src, in_dst, nv)
            tile = DST_TILE
            # the in-edge list is sorted by target: the tables' row offsets
            # are the prefix sum of in-degrees, exact per-range edge counts
            # without touching the device at execute time
            handle = _CudaHandle(
                kind="pr_pull",
                tables=tables,
                num_vertices=nv,
                edge_prefix=tracing.host_read(tables.row_ptr[: nv + 1]).numpy(),
            )
            if shard is not None:
                # the shard's target vertices [v_lo, v_hi) cover dst tiles
                # [tile_lo, tile_hi); the slab is the shard-local device state
                handle.tile_lo = int(shard.v_lo) // tile
                handle.tile_hi = -(-int(shard.v_hi) // tile)
                handle.slab = tables.slab(handle.tile_lo, handle.tile_hi)
            self._warm_spmv(handle)
        elif kind == "bfs":
            src, dst = executor.out_edges()
            nv = int(executor.graph.num_vertices)
            tables = self._spmv_tables((gkey, "out"), src, dst, nv)
            handle = _CudaHandle(kind="bfs", tables=tables, num_vertices=nv)
            self._warm_spmv(handle)
        elif kind == "degree_count":
            from ..kernels.degree_count.ops import count_into

            src, dst = executor.edge_endpoints()
            c = int(executor.num_counters)
            # endpoint ids in edge order, reduced mod the counter array,
            # kept on the device as one [2, E] table
            with tracing.span("backend.stage"):
                ids = (torch.stack([src, dst]) % c).to(torch.int32)
            handle = _CudaHandle(kind="degree_count", num_vertices=c, ids=ids)
            # build and load the kernel outside any measured window
            warm = torch.zeros((c,), dtype=torch.int32, device=ids.device)
            count_into(ids[:, :1], warm)
            _sync_if_cuda(executor)
        else:
            handle = _CudaHandle(kind="inline")
        if hkey is not None:
            self._graph_tables[hkey] = handle
        return self._memo.put(DevicePlan(executor, prep, handle, shard=shard))

    # ---------------------------------------------------------- execution
    def _tile_slab(self, handle: _CudaHandle, a: int, b: int):
        """(tables, a', b') for absolute dst tiles [a, b): the shard-local
        slab when the range lies inside the plan's shard (the common case
        under locality placement — the dispatch never touches other shards'
        tables), the full tables otherwise (a drifted frontier stays
        exact)."""
        if handle.slab is not None and a >= handle.tile_lo and b <= handle.tile_hi:
            lo = handle.tile_lo
            return handle.slab, a - lo, b - lo
        return handle.tables, a, b

    def _spmv_range(self, handle: _CudaHandle, contrib, t0: int, t1: int):
        """Aggregate dst tiles [t0, t1) in one launch; returns the flat
        [(t1-t0)*tile] per-target sums."""
        from ..kernels.spmv.ops import spmv_tiles

        tables, a, b = self._tile_slab(handle, t0, t1)
        return spmv_tiles(tables, contrib, a, b).reshape(-1)

    def _ranges(self, plan: DevicePlan, step: "ScheduleStep") -> list[tuple[int, int]]:
        """The batch's contiguous frontier-slot ranges."""
        from ..algorithms.common import merge_ranges

        return merge_ranges(plan.prep.packages.bounds, step.batch)

    def _execute_pr_pull(
        self, plan: DevicePlan, step: "ScheduleStep"
    ) -> None:
        h = plan.handle
        ex = plan.executor
        tile = DST_TILE
        for lo, hi in self._ranges(plan, step):
            t0, t1 = lo // tile, -(-hi // tile)
            flat = self._spmv_range(h, ex.contrib, t0, t1)
            # unpad: mask lanes outside [lo, hi) before applying the partial
            base = t0 * tile
            ids = base + torch.arange(flat.shape[0], device=flat.device)
            masked = torch.where((ids >= lo) & (ids < hi), flat, 0.0)
            agg = torch.zeros((h.num_vertices,), dtype=flat.dtype, device=flat.device)
            end = min(base + flat.shape[0], h.num_vertices)
            agg[base:end] = masked[: end - base]
            edges = float(h.edge_prefix[hi] - h.edge_prefix[lo])
            with tracing.span("executor.apply"):
                ex.apply_pull_aggregate(agg, lo, hi, edges)

    def _execute_bfs(self, plan: DevicePlan, step: "ScheduleStep") -> None:
        h = plan.handle
        ex = plan.executor
        n_tiles = h.tables.n_tiles
        for lo, hi in self._ranges(plan, step):
            if ex.level_expanded():
                # an earlier range of this level swept for the whole frontier
                tracing.count("bfs.ranges_served")
                with tracing.span("executor.apply"):
                    ex.account_range(lo, hi)
                continue
            # the level's first range expands the whole frontier (slots [0,
            # n_frontier); the executor clamps the end): the sweep reads
            # every edge whatever the frontier, so the level's other ranges
            # need none of their own
            members = ex.frontier_slot_vertices(0, h.num_vertices)
            contrib = torch.zeros(
                (h.num_vertices,), dtype=torch.float32, device=members.device
            )
            contrib[members.to(torch.int64)] = 1.0
            # members' out-neighbours may land in any target tile → full grid
            counts = self._spmv_range(h, contrib, 0, n_tiles)
            tracing.count("bfs.level_sweeps")
            with tracing.span("executor.apply"):
                ex.apply_expansion(counts[: h.num_vertices], lo, hi)

    def _execute_degree_count(
        self, plan: DevicePlan, step: "ScheduleStep"
    ) -> None:
        from ..kernels.degree_count.ops import count_into

        h = plan.handle
        ex = plan.executor
        for lo, hi in self._ranges(plan, step):
            # both endpoints of every edge in [lo, hi)
            total = torch.zeros((h.num_vertices,), dtype=torch.int32, device=h.ids.device)
            count_into(h.ids[:, lo:hi], total)
            with tracing.span("executor.apply"):
                ex.apply_counts(total, lo, hi)

    def execute(
        self, plan: DevicePlan, step: "ScheduleStep", modeled_ns: float = 0.0
    ) -> float:
        """Run one step's batch through the lowered kernel; returns real ns.
        Its span's self time is the host's dispatch: the launches and the
        torch operations around them."""
        with tracing.span("backend.execute"):
            t0 = time.perf_counter_ns()
            kind = plan.handle.kind
            if kind == "pr_pull":
                self._execute_pr_pull(plan, step)
            elif kind == "bfs":
                self._execute_bfs(plan, step)
            elif kind == "degree_count":
                self._execute_degree_count(plan, step)
            else:
                _run_inline(plan, step)
            _sync_if_cuda(plan.executor)
            return float(time.perf_counter_ns() - t0)


_BACKENDS = {
    "modeled": ModeledBackend,
    "inline": InlineBackend,
    "cuda": CudaBackend,
}


def resolve_backend(spec: "ExecutionBackend | str | None") -> "ExecutionBackend":
    """Resolve a backend spec: an instance passes through, a name
    (``"modeled"`` | ``"inline"`` | ``"cuda"``) constructs the default
    instance, ``None`` means the modeled default."""
    if spec is None:
        return ModeledBackend()
    if isinstance(spec, str):
        try:
            return _BACKENDS[spec]()
        except KeyError:
            raise ValueError(
                f"unknown execution backend {spec!r} "
                f"(known: {sorted(_BACKENDS)})"
            ) from None
    if not isinstance(spec, ExecutionBackend):
        raise TypeError(f"not an ExecutionBackend: {spec!r}")
    return spec
