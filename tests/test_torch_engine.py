"""The port's multi-query engine against the JAX package's on the benchmark
workload shapes: every modeled number (per-record modeled time, edges and
decision traces, makespan, throughput) is exactly equal; plus the engine
probes and the ``cuda`` backend's lowerings on CPU tensors (plain versions)."""
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.algorithms as jalg  # noqa: E402
import repro.core as jcore  # noqa: E402
import repro_torch.algorithms as talg  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro.graph import rmat_graph  # noqa: E402
from repro_torch.graph import rmat_graph as rmat_graph_port  # noqa: E402
from _torch_parity import hubs, port_graph, records, report_numbers  # noqa: E402

PKG = {"jax": (jalg, jcore), "torch": (talg, tcore)}

# fig20's tenant mix (benchmarks/fig20_hetero_fusion.py)
FIG20_ALGOS = ("pr_pull",) * 6 + ("bfs",) * 4 + ("degree_count",) * 2
FIG20_VARIANTS = {"nofuse": (False, False), "homofuse": (True, False), "heterofuse": (True, True)}


def _pair(scale):
    jg = rmat_graph(scale, seed=3)
    return {"jax": jg, "torch": port_graph(jg)}


@pytest.fixture(scope="module")
def graphs():
    return _pair(10)


@pytest.fixture(scope="module")
def graphs11():
    return _pair(11)  # the smallest RMAT scale at which fig20's sessions fuse


@pytest.fixture(scope="module")
def graphs12():
    return _pair(12)  # the smallest RMAT scale at which fig14's sessions steal


def make_executor(alg, algorithm, graph, seed=0):
    """benchmarks/common.py::make_executor for either package."""
    if algorithm == "bfs":
        return alg.BFSExecutor(graph, int(hubs(graph.out_degrees())[seed % 8]))
    if algorithm in ("pr_pull", "pr_push"):
        return alg.PageRankExecutor(graph, mode=algorithm.split("_")[1], max_iters=5, tol=0)
    if algorithm == "degree_count":
        return alg.DegreeCountExecutor(graph)
    raise ValueError(algorithm)


def _run(pkg, graph, mk, *, sessions, queries=1, policy="scheduler", pool=None, backend=None, **cfg):
    alg, core = PKG[pkg]
    kw = {} if pool is None else {"pool_capacity": pool}
    eng = core.MultiQueryEngine(core.XEON_E5_2660V4, policy=policy, backend=backend, **kw)
    made = []

    def make(s, q):
        ex = mk(alg, graph, s, q)
        made.append(ex)
        return ex

    fusion = cfg.pop("fusion", None)
    rep = eng.run_sessions(
        make,
        sessions=sessions,
        queries_per_session=queries,
        config=core.EngineConfig(
            fusion=core.FusionConfig(**fusion) if fusion else None, **cfg
        ),
    )
    assert eng.pool.available == eng.pool.capacity  # no leaked grants
    return rep, made


def _parity(graphs, mk, **kw):
    jrep, _ = _run("jax", graphs["jax"], mk, **kw)
    trep, made = _run("torch", graphs["torch"], mk, **kw)
    assert records(trep) == records(jrep)
    assert report_numbers(trep) == report_numbers(jrep)
    assert trep.throughput_modeled() > 0
    return trep, made


def _pr_pull(alg, graph, s, q):
    return make_executor(alg, "pr_pull", graph, s)


def _skew(alg, graph, s, q):
    """fig14: one heavy PageRank session plus short BFS sessions."""
    if s == 0:
        return alg.PageRankExecutor(graph, mode="pull", max_iters=6, tol=0)
    return alg.BFSExecutor(graph, int(hubs(graph.out_degrees())[s % 8]))


def _fig20(alg, graph, s, q):
    return make_executor(alg, FIG20_ALGOS[s], graph, s)


def _fig20_cfg(variant):
    fuse, hetero = FIG20_VARIANTS[variant]
    return dict(
        steal=True,
        fuse=fuse,
        hetero_fuse=hetero,
        fusion=dict(hold_ns=5e4, max_members=12) if fuse else None,
    )


@pytest.mark.parametrize("policy", ["sequential", "simple", "scheduler"])
def test_fig10_pr_sessions_match_jax(graphs, policy):
    _parity(graphs, _pr_pull, sessions=4, queries=2, policy=policy, steal=True)


@pytest.mark.parametrize("steal", [True, False])
def test_fig14_skew_mix_matches_jax(graphs12, steal):
    rep, _ = _parity(graphs12, _skew, sessions=8, pool=16, steal=steal)
    assert (rep.total_stolen > 0) == steal


@pytest.mark.parametrize("variant", sorted(FIG20_VARIANTS))
def test_fig20_mix_matches_jax(graphs11, variant):
    rep, _ = _parity(graphs11, _fig20, sessions=len(FIG20_ALGOS), pool=16, **_fig20_cfg(variant))
    if variant != "nofuse":
        assert rep.total_fused > 0


# ---------------- the committed benchmark rows, reproduced ----------------

BENCH_ROWS = {
    r["name"]: r["modeled_eps"]
    for r in json.loads((pathlib.Path(__file__).resolve().parents[1] / "BENCH_sessions.json").read_text())["rows"]
    if r.get("modeled_eps") is not None
}
GATED = sorted(
    n for n in BENCH_ROWS
    if n.count("/") == 4 and n.startswith(("fig10/pr_pull/sf13", "fig14/", "fig20/"))
)


@pytest.fixture(scope="module")
def sf13():
    return rmat_graph_port(13, seed=3, device="cpu")


@pytest.mark.parametrize("row", GATED)
def test_gated_bench_rows_reproduced(sf13, row):
    """The port's engine on its own sf13 graph gives the JAX benchmark's
    modeled throughput (BENCH_sessions.json) to the last bit."""
    fig, _, _, variant, s = row.split("/")
    sessions = int(s[1:])
    if fig == "fig10":
        rep, _ = _run("torch", sf13, _pr_pull, sessions=sessions, policy=variant, steal=True)
    elif fig == "fig14":
        rep, _ = _run("torch", sf13, _skew, sessions=sessions, pool=16, steal=variant == "steal")
    else:
        rep, _ = _run("torch", sf13, _fig20, sessions=sessions, pool=16, **_fig20_cfg(variant))
    assert rep.throughput_modeled() == BENCH_ROWS[row]


def test_single_session_run_sessions_equals_run_query(graphs):
    g = graphs["torch"]
    rep, _ = _run("torch", g, _pr_pull, sessions=1)
    eng = tcore.MultiQueryEngine(tcore.XEON_E5_2660V4, policy="scheduler")
    rec = tcore.QueryRecord(0, 0, "pr_pull")
    eng.run_query(make_executor(talg, "pr_pull", g), rec)
    assert rep.records[0].traces == rec.traces
    assert rep.records[0].modeled_ns == rec.modeled_ns
    assert eng.pool.available == eng.pool.capacity


# ---------------- backend="cuda" on CPU tensors (plain versions) ----------------

def _oracle_check(graph, ex):
    if isinstance(ex, talg.BFSExecutor):
        np.testing.assert_array_equal(ex.result(), talg.bfs_reference(graph, ex.source))
    elif isinstance(ex, talg.DegreeCountExecutor):
        want = talg.degree_count_reference(graph.src.numpy(), graph.dst.numpy(), ex.num_counters)
        np.testing.assert_array_equal(ex.result(), want)
    else:
        want = talg.pagerank_reference(graph, iters=ex._iter)
        np.testing.assert_allclose(ex.result(), want, rtol=2e-4, atol=1e-8)


@pytest.mark.parametrize("variant", ["nofuse", "heterofuse"])
def test_cuda_backend_fig20_matches_oracles_and_modeled(graphs11, variant):
    g = graphs11["torch"]
    kw = dict(sessions=len(FIG20_ALGOS), pool=16, **_fig20_cfg(variant))
    mrep, _ = _run("torch", g, _fig20, backend="modeled", **kw)
    crep, made = _run("torch", g, _fig20, backend="cuda", **kw)
    for ex in made:
        _oracle_check(g, ex)
    # without feedback the modeled clock alone schedules: same decisions
    assert [r.modeled_ns for r in crep.records] == [r.modeled_ns for r in mrep.records]
    assert [r.traces for r in crep.records] == [r.traces for r in mrep.records]
    assert [r.edges for r in crep.records] == [r.edges for r in mrep.records]
    assert crep.makespan_modeled_ns == mrep.makespan_modeled_ns
    assert crep.throughput_modeled() == mrep.throughput_modeled()
    assert all(r.measured_ns > 0 for r in crep.records)


def test_cuda_backend_pr_stable_across_gang_widths(graphs):
    """Gang width → grid slices is a performance knob, not a semantic one:
    a solo wide-gang query and a contended 4-session run give identical
    PageRank ranks."""
    g = graphs["torch"]
    solo = tcore.MultiQueryEngine(tcore.XEON_E5_2660V4, policy="scheduler", backend="cuda")
    ex_solo = talg.PageRankExecutor(g, mode="pull", max_iters=3, tol=0)
    solo.run_query(ex_solo, tcore.QueryRecord(0, 0, "pr_pull"))
    _, made = _run(
        "torch", g, lambda alg, gr, s, q: alg.PageRankExecutor(gr, mode="pull", max_iters=3, tol=0),
        sessions=4, pool=4, backend="cuda", steal=True,
    )
    for ex in made:
        np.testing.assert_allclose(ex.result(), ex_solo.result(), rtol=1e-6)


def test_cuda_backend_inline_fallback_without_lowering(graphs):
    """PR-push and direction-optimized BFS have no kernel lowering: the
    backend runs them inline and the results still match the oracles."""
    g = graphs["torch"]
    eng = tcore.MultiQueryEngine(tcore.XEON_E5_2660V4, policy="scheduler", backend="cuda")
    push = talg.PageRankExecutor(g, mode="push", max_iters=4, tol=0)
    eng.run_query(push, tcore.QueryRecord(0, 0, "pr_push"))
    _oracle_check(g, push)
    src = int(hubs(g.out_degrees())[0])
    dob = talg.DirectionOptimizedBFSExecutor(g, src)
    eng.run_query(dob, tcore.QueryRecord(0, 1, "bfs"))
    np.testing.assert_array_equal(dob.result(), talg.bfs_reference(g, src))


def test_cuda_backend_shard_slab_dispatch(graphs):
    """With locality domains the PR-pull plan stages its shard's slab;
    results stay exact and the modeled clock matches the modeled backend."""
    g = graphs["torch"]
    kw = dict(sessions=4, pool=16, steal=True, domains=2)
    mrep, _ = _run("torch", g, _pr_pull, backend="modeled", **kw)
    crep, made = _run("torch", g, _pr_pull, backend="cuda", **kw)
    for ex in made:
        _oracle_check(g, ex)
    assert crep.makespan_modeled_ns == mrep.makespan_modeled_ns


def test_resolve_backend_specs():
    assert isinstance(tcore.resolve_backend(None), tcore.ModeledBackend)
    assert isinstance(tcore.resolve_backend("cuda"), tcore.CudaBackend)
    assert isinstance(tcore.resolve_backend("inline"), tcore.InlineBackend)
    for b in (tcore.ModeledBackend(), tcore.InlineBackend(), tcore.CudaBackend()):
        assert isinstance(b, tcore.ExecutionBackend)
    with pytest.raises(ValueError, match="unknown execution backend"):
        tcore.resolve_backend("pallas")
