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
  count. A PageRank-pull range is widened to tile boundaries for the
  launch, which writes the row sums into the graph's row buffer at their
  own rows; the executor then adds only the range's lanes into its
  accumulator, in place, so results stay exact and nothing ``[V]``-wide is
  made a range. Algorithms without a kernel lowering (PR-push,
  direction-optimized BFS) run the inline path.

The protocol splits *preparation* from *execution* deliberately:
``prepare`` may build kernels, stage device tile tables and warm them;
``execute`` measures steady-state kernel time only. The engine never times
``prepare``, so a build cannot pollute the width-feedback EWMA's first
observation. A plan lives as long as the step it serves: graph-wide device
state is owned once per graph (the graph's own views, ``CudaBackend``'s
per-graph tables), and no backend keeps an executor.
"""
from __future__ import annotations

import dataclasses
import time
from typing import TYPE_CHECKING, Any, Protocol, runtime_checkable

import numpy as np
import torch

from . import tracing
from .stealing import graph_identity
from ..kernels.spmv.spmv import DST_TILE

if TYPE_CHECKING:  # pragma: no cover - annotation-only imports (no cycles)
    from .autotuner import PreparedIteration
    from .scheduler import ScheduleStep
    from .session import QueryExecutor


@dataclasses.dataclass(frozen=True)
class DevicePlan:
    """Backend-prepared execution state for one (executor, prep) pair.

    ``handle`` is backend-private (device tile tables, prefix sums for
    edge counts, a row buffer) and shared by every plan on the same graph;
    the engine only ever passes the plan back to the backend that built
    it."""

    executor: "QueryExecutor"
    prep: "PreparedIteration"
    handle: Any = None


@runtime_checkable
class ExecutionBackend(Protocol):
    """Where a schedule step's packages execute.

    ``prepare`` is called before every ``execute``, outside the measured
    window; the first call on a graph may be arbitrarily slow — kernel
    builds and device staging belong there — and later ones return a new
    plan around the graph's staged state. ``execute`` runs one step's
    package batch at the granted width and returns the measured nanoseconds
    that flow into records and the §4.4 feedback tables. ``modeled_ns`` is
    the engine's modeled cost for the step — substrates that do no
    wall-clock timing echo it back."""

    name: str

    def prepare(self, executor: "QueryExecutor", prep: "PreparedIteration") -> DevicePlan:
        """A plan for one (executor, prep) pair; stages the graph's device
        state (build kernels, stage tables, warm them) on first use."""
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

    def prepare(self, executor: "QueryExecutor", prep: "PreparedIteration") -> DevicePlan:
        """No device staging needed; returns a bare (executor, prep) plan."""
        return DevicePlan(executor, prep)

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
    prepare = ModeledBackend.prepare

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
    rows: torch.Tensor | None = None  # [n_tiles * DST_TILE] float32: launches' row sums (pr_pull)
    ids: Any = None                # [2, E] int32 endpoint ids mod C (degree_count)


# the handle of executors without a kernel lowering: they run inline
_INLINE = _CudaHandle(kind="inline")


class CudaBackend:
    """Dispatch package batches onto the hand-written CUDA graph kernels.

    Lowerings, each one kernel launch per merged package range whatever
    the step's gang width (BFS: one per level; see the module docstring
    for why):

    * ``pagerank_pull`` — a package batch is a contiguous range of *target*
      vertices; the ragged dst-tile layout built by
      ``kernels/spmv/ops.build_tiles`` is sliced to the tiles covering the
      range, and the SpMV kernel writes each target's in-edge sum into the
      graph's row buffer at the target's own row. The executor adds lanes
      ``[lo, hi)`` of the buffer into its accumulator in place; the
      buffer's other lanes hold whatever an earlier launch left and are
      never read.
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
        # graph-level device state, the backend's only cache: raw tile
        # tables under (gkey, "in"|"out"), and *whole warmed handles* under
        # (gkey, kind, counters) — the topology is staged and the kernel
        # warmed once per graph, so N concurrent sessions (same or
        # different algorithms, scan-shared gangs included) load it once.
        # A handle holds no executor
        self._graph_tables: dict[tuple, _CudaHandle] = {}

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

    def prepare(self, executor: "QueryExecutor", prep: "PreparedIteration") -> DevicePlan:
        """A plan around the graph's handle: device tile tables staged and
        the kernel warmed on the graph's first plan of a lowering, reused
        by every later one."""
        # executors opt into a kernel lowering explicitly (a subclass whose
        # run_packages carries extra semantics — direction-optimized BFS —
        # opts back out by clearing the attribute)
        kind = getattr(executor, "kernel_lowering", None)
        gkey = graph_identity(executor)
        if kind not in ("pr_pull", "bfs", "degree_count") or gkey is None:
            return DevicePlan(executor, prep, _INLINE)
        # ids are reduced mod the counter-array size
        counters = int(executor.num_counters) if kind == "degree_count" else None
        hkey = (gkey, kind, counters)
        handle = self._graph_tables.get(hkey)
        if handle is None:
            with tracing.span("backend.prepare"):
                handle = self._stage(executor, kind, gkey)
            self._graph_tables[hkey] = handle
        return DevicePlan(executor, prep, handle)

    def _stage(self, executor: "QueryExecutor", kind: str, gkey) -> _CudaHandle:
        """Stage and warm a graph's handle for one lowering."""
        if kind == "pr_pull":
            in_src, in_dst = executor.pull_edges()
            nv = int(executor.graph.num_vertices)
            tables = self._spmv_tables((gkey, "in"), in_src, in_dst, nv)
            # the in-edge list is sorted by target: the tables' row offsets
            # are the prefix sum of in-degrees, exact per-range edge counts
            # without touching the device at execute time
            handle = _CudaHandle(
                kind="pr_pull",
                tables=tables,
                num_vertices=nv,
                edge_prefix=tracing.host_read(tables.row_ptr[: nv + 1]).numpy(),
                rows=torch.zeros(
                    (tables.n_tiles * DST_TILE,), dtype=torch.float32, device=tables.src.device
                ),
            )
            self._warm_spmv(handle)
        elif kind == "bfs":
            src, dst = executor.out_edges()
            nv = int(executor.graph.num_vertices)
            tables = self._spmv_tables((gkey, "out"), src, dst, nv)
            handle = _CudaHandle(kind="bfs", tables=tables, num_vertices=nv)
            self._warm_spmv(handle)
        else:
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
        return handle

    # ---------------------------------------------------------- execution
    def _spmv_range(self, handle: _CudaHandle, contrib, t0: int, t1: int, out=None):
        """Aggregate dst tiles [t0, t1) in one launch; returns the flat
        [(t1-t0)*tile] per-target sums (a view of ``out`` when given)."""
        from ..kernels.spmv.ops import spmv_tiles

        # ``out`` goes positionally: wrappers of spmv_tiles pass *args on
        return spmv_tiles(handle.tables, contrib, t0, t1, out).reshape(-1)

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
        # the launch writes rows [t0, t1) * tile of the buffer; the executor
        # reads lanes [lo, hi) of it, at the same absolute indices
        agg = h.rows[: h.num_vertices]
        for lo, hi in self._ranges(plan, step):
            t0, t1 = lo // tile, -(-hi // tile)
            self._spmv_range(h, ex.contrib, t0, t1, h.rows[t0 * tile : t1 * tile])
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
