"""The benchmark figures' engine runs (benchmarks/fig*.py), rebuilt on the
port's engine for the gated-row tests: each figure's graph, executors and
``EngineConfig`` as the figure module sets them, with the graph built by the
port on the CPU. ``run_row(name)`` runs the setting one row of
``BENCH_sessions.json`` names and returns the engine's report.

fig22's run takes the package's modules as an argument, so the dynamic
tests drive the same run on the JAX package too."""
from __future__ import annotations

import functools
import json
import pathlib

import numpy as np
import pytest
import torch

import repro_torch.algorithms as talg
import repro_torch.core as tcore
import repro_torch.graph as tgraph
from _torch_parity import hubs

PORT = (talg, tcore, tgraph)
BENCH = pathlib.Path(__file__).resolve().parents[1] / "BENCH_sessions.json"


def gated_rows() -> dict[str, float]:
    """Every gated modeled row: a figure/workload/dataset/variant/sessions
    name (four ``/``), a modeled throughput, and no ``informational`` flag.
    fig21's measured ratios and every ``_wall`` row are host wall-time
    measurements, flagged informational or without a modeled throughput."""
    rows = json.loads(BENCH.read_text())["rows"]
    return {
        r["name"]: r["modeled_eps"]
        for r in rows
        if r["name"].count("/") == 4 and r.get("modeled_eps") is not None and not r.get("informational")
    }


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Each test on one CPU thread (autouse in the modules that import it):
    the engine's small tensor ops gain nothing from torch's thread pool, and
    pytest-xdist's workers each starting a pool as wide as the host
    oversubscribe it, which slows every op that waits on the pool by orders
    of magnitude."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_executor(alg, algorithm, graph, seed=0):
    """benchmarks/common.py::make_executor for either package."""
    if algorithm == "bfs":
        return alg.BFSExecutor(graph, int(hubs(graph.out_degrees())[seed % 8]))
    if algorithm in ("pr_pull", "pr_push"):
        return alg.PageRankExecutor(graph, mode=algorithm.split("_")[1], max_iters=5, tol=0)
    if algorithm == "degree_count":
        return alg.DegreeCountExecutor(graph)
    raise ValueError(algorithm)


def _engine(policy="scheduler", **kw):
    return tcore.MultiQueryEngine(tcore.XEON_E5_2660V4, policy=policy, **kw)


def _sessions(eng, mk, sessions, queries=1, **cfg):
    rep = eng.run_sessions(
        mk, sessions=sessions, queries_per_session=queries, config=tcore.EngineConfig(**cfg)
    )
    assert eng.pool.available == eng.pool.capacity  # no leaked grants
    return rep


# ---------------- graphs (built once per test process) ----------------

@functools.cache
def rmat(scale):
    return tgraph.rmat_graph(scale, seed=3, device="cpu")


@functools.cache
def dataset(name):
    return tgraph.load_dataset(name, scale_div=512, device="cpu")


@functools.cache
def clustered():
    return tgraph.clustered_graph(FIG19_SCALE, FIG19_CLUSTERS, seed=3, cross_fraction=0.0, device="cpu")


# ---------------- figure settings ----------------

def common_sessions(algorithm, graph, policy, sessions):
    """benchmarks/common.py::run_sessions with its defaults (stealing on)."""
    return _sessions(
        _engine(policy),
        lambda s, q: make_executor(talg, algorithm, graph, seed=s),
        sessions,
        steal=True,
    )


# fig15: two Poisson bursts of 12 on P0=16, governed or fixed
FIG15_SESSIONS, FIG15_POOL, FIG15_PR_ITERS = 24, 16, 4


def fig15(variant):
    g = rmat(12)
    rng = np.random.default_rng(7)
    half, scale = FIG15_SESSIONS // 2, 1e9 / 30_000.0
    arrivals = np.concatenate([
        np.cumsum(rng.exponential(scale, size=half)),
        2.5e6 + np.cumsum(rng.exponential(scale, size=half)),
    ])
    h = hubs(g.out_degrees())

    def mk(s, q):
        if s % 3 == 0:
            return talg.BFSExecutor(g, int(h[s % 8]))
        return talg.PageRankExecutor(g, mode="pull", max_iters=FIG15_PR_ITERS, tol=0)

    governor, admission = None, tcore.AdmissionController()
    if variant == "governed":
        governor = tcore.CapacityGovernor(
            p_min=4, p_max=32, window_ns=1e5, cooldown_ns=1.5e5, shrink_util=0.5, grow_step=32, preempt=True
        )
        admission = tcore.AdmissionController(class_quotas={0: 12})
    eng = _engine(pool_capacity=FIG15_POOL, admission=admission)
    return _sessions(
        eng, mk, FIG15_SESSIONS, arrivals=arrivals, priorities=lambda sid: 1 if sid % 3 == 0 else 0,
        steal=True, governor=governor,
    )


# fig16: 6 PageRank + 6 BFS sessions on one sf13 graph, P=16
FIG16_N_EACH, FIG16_PR_ITERS, FIG16_HOLD_NS, POOL16 = 6, 4, 2e4, 16


def fig16_mk(g):
    h = hubs(g.out_degrees())

    def mk(s, q):
        if s < FIG16_N_EACH:
            return talg.PageRankExecutor(g, mode="pull", max_iters=FIG16_PR_ITERS, tol=0)
        return talg.BFSExecutor(g, int(h[s % 8]))

    return mk


def fig14_mk(g):
    """benchmarks/fig14_steal_sessions_rmat.py: 1 heavy PageRank + 7 BFS."""
    h = hubs(g.out_degrees())

    def mk(s, q):
        if s == 0:
            return talg.PageRankExecutor(g, mode="pull", max_iters=6, tol=0)
        return talg.BFSExecutor(g, int(h[s % 8]))

    return mk


def fig16(variant):
    fuse = variant == "fused"
    return _sessions(
        _engine(pool_capacity=POOL16), fig16_mk(rmat(13)), 2 * FIG16_N_EACH, steal=True, fuse=fuse,
        fusion=tcore.FusionConfig(hold_ns=FIG16_HOLD_NS) if fuse else None,
    )


def fig17(workload, variant):
    """fig14's skew mix or fig16's fused burst on the inline backend with a
    CostFeedback installed, width feedback off (nofb) or on (widthfb)."""
    g = rmat(13)
    eng = _engine(pool_capacity=POOL16, feedback=tcore.CostFeedback())
    cfg = dict(steal=True, width_feedback=variant == "widthfb", backend="inline")
    if workload == "skew_mix":
        return _sessions(eng, fig14_mk(g), 8, fuse=False, **cfg)
    return _sessions(
        eng, fig16_mk(g), 2 * FIG16_N_EACH, fuse=True, fusion=tcore.FusionConfig(hold_ns=FIG16_HOLD_NS), **cfg
    )


# fig18: the fig10 PR burst and a skew mix through each backend on sf11; the
# JAX figure's interpret-mode ``pallas`` substrate is the port's ``cuda``
FIG18_SESSIONS, FIG18_POOL, FIG18_PR_ITERS = 4, 8, 3
FIG18_BACKENDS = {"modeled": "modeled", "inline": "inline", "pallas": "cuda"}


def fig18(workload, variant):
    g = rmat(11)
    h = hubs(g.out_degrees())

    def mk(s, q):
        if workload == "pr_sessions" or s == 0:
            return talg.PageRankExecutor(g, mode="pull", max_iters=FIG18_PR_ITERS, tol=0)
        return talg.BFSExecutor(g, int(h[s % 4]))

    return _sessions(
        _engine(pool_capacity=FIG18_POOL), mk, FIG18_SESSIONS,
        steal=workload == "skew_mix", backend=FIG18_BACKENDS[variant],
    )


# fig19: locality domains on four closed RMAT communities
FIG19_SCALE, FIG19_CLUSTERS, FIG19_SESSIONS, FIG19_QUERIES, FIG19_PR_ITERS = 10, 4, 8, 3, 2
FIG19_VARIANTS = {
    "d1": dict(domains=1),
    "d4_local": dict(domains=4, placement="locality"),
    "d4_blind": dict(domains=4, placement="round_robin"),
    "d4_nopen": dict(domains=4, placement="round_robin", migration_penalty=False),
}


def fig19(variant):
    g = clustered()
    block = 1 << FIG19_SCALE

    def mk(s, q):
        if s % 4 == 3:
            return talg.PageRankExecutor(g, mode="pull", max_iters=FIG19_PR_ITERS, tol=0)
        return talg.BFSExecutor(g, ((s + 1) % FIG19_CLUSTERS) * block + (s * 131 + q * 17) % block)

    return _sessions(
        _engine(pool_capacity=POOL16), mk, FIG19_SESSIONS, FIG19_QUERIES,
        steal=True, fuse=True, **FIG19_VARIANTS[variant],
    )


# fig22: a live-ingest writer under 8 reader sessions
FIG22_POOL, FIG22_SESSIONS, FIG22_QUERIES = 8, 8, 2
FIG22_ALGOS = ("pr_pull", "bfs", "pr_push", "bfs", "pr_pull", "bfs", "pr_pull", "bfs")
BASE_FRACTION, N_BATCHES, INTERVAL_NS, ARRIVAL_GAP_NS = 0.85, 6, 6e5, 4.5e5


def split_stream(
    graph, scale, *, seed=3, base_fraction=BASE_FRACTION, n_batches=N_BATCHES, name="sf12_dyn", device="cpu"
):
    """(base graph, [(src, dst), ...] writer batches) from one RMAT stream,
    built by either package's ``graph`` module (the port's on ``device``)."""
    src, dst = tgraph.rmat_edges(scale, seed=seed)
    cut = max(int(src.size * base_fraction), 1)
    kw = {"device": device} if graph is tgraph else {}
    base = graph.build_graph(src[:cut], dst[:cut], 2 ** scale, name=name, **kw)
    parts = np.array_split(np.arange(cut, src.size), n_batches)
    return base, [(src[i], dst[i]) for i in parts]


def run_fig22(dynamic, *, pkg=PORT, scale=12, backend=None, device="cpu"):
    """benchmarks/fig22_dynamic.py's run -> (report, {(s, q): executor}, log)."""
    alg, core, graph = pkg
    base, batches = split_stream(graph, scale, device=device)
    log = graph.GraphEpochLog(base) if dynamic else None
    stream = core.IngestStream(log=log, batches=batches, interval_ns=INTERVAL_NS) if dynamic else None
    pinned = {}

    def mk(s, q):
        ex = make_executor(alg, FIG22_ALGOS[s], log.current() if dynamic else base, seed=s)
        pinned[(s, q)] = ex
        return ex

    eng = core.MultiQueryEngine(core.XEON_E5_2660V4, pool_capacity=FIG22_POOL, policy="scheduler")
    rep = eng.run_sessions(
        mk,
        sessions=FIG22_SESSIONS,
        queries_per_session=FIG22_QUERIES,
        config=core.EngineConfig(
            steal=True,
            fuse=True,
            arrivals=[i * ARRIVAL_GAP_NS for i in range(FIG22_SESSIONS)],
            dynamic=dynamic,
            ingest=stream,
            backend=backend,
        ),
    )
    assert eng.pool.available == eng.pool.capacity
    return rep, pinned, log


# ---------------- one row ----------------

def run_row(name: str):
    """The engine report of the run one gated row names."""
    fig, workload, data, variant, s = name.split("/")
    sessions = int(s[1:])
    if fig == "fig11":
        return common_sessions("bfs", rmat(13), variant, sessions)
    if fig in ("fig12", "fig13"):
        return common_sessions(workload, dataset(data), variant, sessions)
    if fig == "fig15":
        return fig15(variant)
    if fig == "fig16":
        return fig16(variant)
    if fig == "fig17":
        return fig17(workload, variant)
    if fig == "fig18":
        return fig18(workload, variant)
    if fig == "fig19":
        return fig19(variant)
    if fig == "fig22":
        return run_fig22(variant == "dynamic")[0]
    raise ValueError(f"no runner for {name}")
