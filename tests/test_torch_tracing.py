"""The port's in-process tracer (``repro_torch.core.tracing``) on the CPU:
``run_sessions`` through ``CudaBackend``'s plain-PyTorch path on a small
RMAT graph and a small lattice, with tracing on and off."""
from __future__ import annotations

import pytest
import torch

import repro_torch.algorithms as alg
from repro_torch import core
from repro_torch.core import tracing
from repro_torch.graph import grid_graph, rmat_graph

# every span the port records, and nothing else (PERF.md names the metric
# that reads each)
DOCUMENTED = {
    "engine.round", "sched.prepare", "sched.bounds", "sched.package", "sched.steal", "sched.fuse",
    "executor.start", "executor.frontier", "executor.finished", "executor.apply",
    "backend.prepare", "backend.stage", "backend.execute", "host.sync",
    "graph.build", "graph.csr", "graph.upload",
}


@pytest.fixture(scope="module")
def graphs():
    return {"rmat": rmat_graph(10, seed=3, device="cpu"), "lattice": grid_graph(24, device="cpu")}


@pytest.fixture(autouse=True)
def tracing_off():
    yield
    tracing.stop()


@pytest.fixture
def cuda_flagged(monkeypatch):
    """Every ``host_read`` counts, as every read would on the card."""
    monkeypatch.setattr(tracing, "_is_cuda", lambda x: True)


def _factory(kind: str, graph):
    """PageRank-pull (5 iterations), BFS from the hubs, or "skew": one
    PageRank beside BFS sessions, whose idle workers steal from it."""
    pr = lambda s, q: alg.PageRankExecutor(graph, mode="pull", max_iters=5, tol=0)
    hubs = torch.argsort(graph.out_degrees(), descending=True, stable=True)
    bfs = lambda s, q: alg.BFSExecutor(graph, int(hubs[s % 8]))
    return {"pr": pr, "bfs": bfs, "skew": lambda s, q: (pr if s == 0 else bfs)(s, q)}[kind]


def _round(kind: str, graph, sessions: int = 16, **config):
    """One round as the graph benchmark runs it: a fresh engine, one query
    a session, steal on, a fresh CudaBackend; the report and the executors."""
    made = []

    def make(s, q):
        ex = _factory(kind, graph)(s, q)
        made.append(ex)
        return ex

    pool = config.pop("pool_capacity", None)
    eng = core.MultiQueryEngine(core.XEON_E5_2660V4, policy="scheduler", pool_capacity=pool)
    cfg = core.EngineConfig(backend=core.CudaBackend(), **config)
    return eng.run_sessions(make, sessions=sessions, queries_per_session=1, config=cfg), made


def _traced_round(kind, graph, **config):
    rec = tracing.start()
    rep, made = _round(kind, graph, **config)
    assert tracing.stop() is rec
    return rec, rep, made


@pytest.mark.parametrize("graph", ["rmat", "lattice"])
@pytest.mark.parametrize("kind", ["pr", "bfs"])
def test_spans_nest_and_self_times_add_up(graphs, cuda_flagged, kind, graph):
    rec, rep, _ = _traced_round(kind, graphs[graph], steal=True)
    spans = rec.spans
    roots = [i for i, s in enumerate(spans) if s[3] < 0]
    assert [spans[i][0] for i in roots] == ["engine.round"]
    for name, a, b, parent, key in spans:
        assert a <= b
        if parent >= 0:
            pa, pb, pkey = spans[parent][1], spans[parent][2], spans[parent][4]
            assert pa <= a and b <= pb, name
            if pkey is not None:
                assert key == pkey, name
    keyed = {s[4] for s in spans if s[0].startswith("executor.")} - {None}
    assert keyed == {(r.session, r.query) for r in rep.records}
    own = rec.self_ns()
    assert min(own) >= 0
    round_ns = spans[0][2] - spans[0][1]
    assert abs(sum(own) - round_ns) <= 0.01 * round_ns
    assert rec.counters["host_syncs"] == sum(s[0] == "host.sync" for s in spans)


@pytest.mark.parametrize("case", ["pr+bfs", "fuse"])
def test_span_names_are_the_documented_set(graphs, cuda_flagged, case):
    rec = tracing.start()
    graph = rmat_graph(12, seed=3, device="cpu")  # graph.build and its children
    if case == "fuse":
        rep, _ = _round("pr", graph, sessions=4, fuse=True, pool_capacity=8)
        assert rep.total_fused > 0
    else:
        rep, _ = _round("skew", graph, sessions=8, steal=True, pool_capacity=16)
        assert rep.total_stolen > 0
    tracing.stop()
    names = {s[0] for s in rec.spans}
    if case == "fuse":
        assert "sched.fuse" in names and names <= DOCUMENTED
    else:
        assert names == DOCUMENTED - {"sched.fuse"}


@pytest.mark.parametrize("kind", ["pr", "bfs"])
def test_host_syncs_equal_a_hand_count(graphs, cuda_flagged, kind):
    """One query alone. Both kinds: one read of the executor's degrees when
    it is made, one synchronize a step, and the kernel's warm-up synchronize
    in the backend's first prepare. PageRank adds the first prepare's read
    of the in-edge offsets and its delta each iteration (5). BFS adds, at
    each frontier call, the visited count and (but the first) the frontier
    copy, and the frontier count at each iteration's end."""
    rec, rep, _ = _traced_round(kind, graphs["rmat"], sessions=1)
    names = [s[0] for s in rec.spans]
    steps, fronts = names.count("backend.execute"), names.count("executor.frontier")
    (r,) = rep.records
    if kind == "pr":
        assert r.iterations == 5
        want = 1 + steps + 1 + 1 + 5
    else:
        assert fronts == r.iterations > 1
        want = 1 + steps + 1 + fronts + (fronts - 1) + r.iterations
    assert rec.counters["host_syncs"] == want


@pytest.mark.parametrize("graph", ["rmat", "lattice"])
@pytest.mark.parametrize("kind", ["pr", "bfs"])
def test_answers_equal_with_tracing_on_and_off(graphs, kind, graph):
    off_rep, off = _round(kind, graphs[graph], steal=True)
    rec, on_rep, on = _traced_round(kind, graphs[graph], steal=True)
    assert rec.spans
    for a, b in zip(off, on):
        assert torch.equal(torch.from_numpy(a.result()), torch.from_numpy(b.result()))
    assert [r.edges for r in off_rep.records] == [r.edges for r in on_rep.records]


def test_tracing_off_records_nothing(graphs):
    assert tracing._rec is None and tracing.stop() is None
    assert tracing.span("engine.round") is tracing.span("host.sync", (0, 0)) is tracing._OFF
    with tracing.span("sched.bounds"):
        tracing.count("host_syncs")
    x = torch.arange(4.0)
    assert torch.equal(tracing.host_read(x), x)
    assert tracing.host_read(x.sum(), float) == 6.0 and tracing.host_read(torch.device("cpu")) is None
    rep, _ = _round("pr", graphs["lattice"], sessions=2)
    assert tracing._rec is None
    assert all(0 < r.submitted_wall_ns <= r.finished_wall_ns for r in rep.records)


@pytest.mark.parametrize("kind", ["pr", "bfs"])
def test_wall_stamps_lie_inside_the_round(graphs, kind):
    rec, rep, _ = _traced_round(kind, graphs["lattice"], steal=True)
    (a, b) = rec.spans[0][1:3]
    assert len(rep.records) == 16
    for r in rep.records:
        assert a <= r.submitted_wall_ns <= r.finished_wall_ns <= b
    # the recorder's clock anchors and the graph kernels' launch counts
    assert len(rec.anchors) == 2 and rec.anchors[0] < rec.anchors[1]
    assert rec.counters["launches.spmv"] == 0  # the plain versions ran
    assert abs(rec.epoch_offset_ns() - (rec.anchors[0][1] - rec.anchors[0][0])) < 1e9
