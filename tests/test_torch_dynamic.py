"""Dynamic graphs on the port's engine: fig22's live-ingest workload
(benchmarks/fig22_dynamic.py) on both packages with equal records and
report numbers, the ``cuda`` backend's epoch pinning on CPU tensors (the
kernels' plain versions), and the runtime's "readers pin, writers publish"
guarantees (prep cache, fusion rendezvous, steal ranking, config hygiene)."""
import warnings
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.algorithms as jalg  # noqa: E402
import repro.core as jcore  # noqa: E402
import repro.graph as jgraph  # noqa: E402
import repro_torch.algorithms as talg  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.graph as tgraph  # noqa: E402
from _torch_bench_rows import one_torch_thread, N_BATCHES, run_fig22, split_stream  # noqa: E402,F401
from _torch_parity import records, report_numbers  # noqa: E402

JAX = (jalg, jcore, jgraph)
PR_RTOL, PR_ATOL = 2e-4, 1e-8


def _numbers(rep):
    return (*report_numbers(rep), rep.ingest_events, rep.epochs_published, rep.epoch_histogram())


@pytest.mark.parametrize("variant", ["static", "dynamic"])
def test_fig22_matches_jax(variant):
    dynamic = variant == "dynamic"
    jrep, _, _ = run_fig22(dynamic, pkg=JAX)
    trep, _, _ = run_fig22(dynamic)
    assert records(trep) == records(jrep)
    assert _numbers(trep) == _numbers(jrep)
    assert trep.epochs_published == (N_BATCHES if dynamic else 0)


def assert_pinned(rep, pinned, log):
    """benchmarks/fig22_dynamic.py::_assert_pinned, with every reader held
    against its own snapshot's oracle."""
    assert rep.epochs_published == N_BATCHES, rep.ingest_events
    for r in rep.records:
        assert r.graph_epoch == pinned[(r.session, r.query)].graph.epoch
    epochs = {r.graph_epoch for r in rep.records}
    assert len(epochs) >= 2 and any(e < log.epoch for e in epochs) and any(e > 0 for e in epochs)
    for ex in pinned.values():
        if isinstance(ex, talg.BFSExecutor):
            np.testing.assert_array_equal(ex.result(), talg.bfs_reference(ex.graph, ex.source))
        else:
            want = talg.pagerank_reference(ex.graph, iters=ex._iter)
            np.testing.assert_allclose(ex.result(), want, rtol=PR_RTOL, atol=PR_ATOL)


def test_fig22_dynamic_cuda_backend_pins_epochs():
    backend = tcore.CudaBackend()
    rep, pinned, log = run_fig22(True, backend=backend)
    assert_pinned(rep, pinned, log)
    mrep, _, _ = run_fig22(True, backend="modeled")
    assert [r.modeled_ns for r in rep.records] == [r.modeled_ns for r in mrep.records]
    assert [r.traces for r in rep.records] == [r.traces for r in mrep.records]
    assert _numbers(rep) == _numbers(mrep)
    # every reader ran on tables staged from its own snapshot, and the
    # backend's table cache keeps every epoch's tables (it has no eviction)
    lowered = [ex for ex in pinned.values() if ex.desc.name != "pagerank_push"]  # push runs inline
    for ex in lowered:
        direction = "out" if isinstance(ex, talg.BFSExecutor) else "in"
        handle = backend._graph_tables[(ex.graph.key, direction)]
        assert int(handle.tables.row_ptr[-1]) == ex.graph.num_edges
    staged = {k[0][1] for k in backend._graph_tables}
    assert staged == {ex.graph.epoch for ex in lowered} and len(staged) >= 2


def test_dynamic_run_keeps_snapshots_on_the_base_graph_device():
    """The whole dynamic run's snapshots stay where the base graph lies."""
    _, pinned, log = run_fig22(True, scale=10, backend="cuda")
    assert log.current().device.type == "cpu"
    assert all(ex.graph.device.type == "cpu" for ex in pinned.values())


# ---------------- readers pin, writers publish ----------------

def test_prep_cache_never_served_across_epoch_boundary():
    """Every executed step's PreparedIteration was prepared against the
    executing query's own pinned snapshot."""
    base, batches = split_stream(tgraph, 9, base_fraction=0.8, n_batches=3, name="prepcache")
    log = tgraph.GraphEpochLog(base)
    stream = tcore.IngestStream(log=log, batches=batches, interval_ns=1.5e5)
    eng = tcore.MultiQueryEngine(tcore.XEON_E5_2660V4, pool_capacity=8, policy="scheduler")
    prep_epoch: dict[int, int] = {}
    orig_prepare, orig_execute = eng._prepare, eng._execute_step

    def prep_wrap(ex, *a, **kw):
        p = orig_prepare(ex, *a, **kw)
        prep_epoch.setdefault(id(p), ex.graph.epoch)
        return p

    def exec_wrap(ex, prep, step, step_ns, **kw):
        assert prep_epoch[id(prep)] == ex.graph.epoch
        return orig_execute(ex, prep, step, step_ns, **kw)

    eng._prepare, eng._execute_step = prep_wrap, exec_wrap
    rep = eng.run_sessions(
        lambda s, q: talg.PageRankExecutor(log.current(), mode="pull", max_iters=4, tol=0),
        sessions=6,
        queries_per_session=2,
        config=tcore.EngineConfig(
            dynamic=True, ingest=stream, fuse=True, arrivals=[i * 1.0e5 for i in range(6)]
        ),
    )
    assert rep.epochs_published == 3
    assert len({r.graph_epoch for r in rep.records}) >= 2
    assert eng.pool.available == eng.pool.capacity


def test_two_snapshots_never_rendezvous_into_one_fusion_group():
    base, batches = split_stream(tgraph, 11, base_fraction=0.9, n_batches=1)
    g1 = tgraph.GraphEpochLog(base).ingest(*batches[0])
    assert base.key != g1.key and base.key[0] == g1.key[0]

    def run(graphs):
        eng = tcore.MultiQueryEngine(tcore.XEON_E5_2660V4, pool_capacity=4, policy="scheduler")
        return eng.run_sessions(
            lambda s, q: talg.PageRankExecutor(graphs[s], mode="pull", max_iters=3, tol=0),
            sessions=2,
            queries_per_session=1,
            config=tcore.EngineConfig(fuse=True, fusion=tcore.FusionConfig(hold_ns=1e6)),
        )

    assert run([base, base]).fusion_events, "control pair on one snapshot failed to fuse"
    assert run([base, g1]).fusion_events == []


def test_two_snapshots_never_rank_as_same_graph_steal_victims():
    base, batches = split_stream(tgraph, 8, base_fraction=0.9, n_batches=1)
    g1 = tgraph.GraphEpochLog(base).ingest(*batches[0])
    reg = tcore.StealRegistry()
    reg.publish(0, SimpleNamespace(stealable_backlog=50, grinding=True), graph_key=base.key)
    reg.publish(1, SimpleNamespace(stealable_backlog=3, grinding=True), graph_key=g1.key)
    assert reg.pick_victim(graph_key=g1.key).key == 1
    assert reg.pick_victim(graph_key=base.key).key == 0


def test_dynamic_flag_path_clean_under_deprecation_errors():
    base, batches = split_stream(tgraph, 8, base_fraction=0.8, n_batches=2)
    log = tgraph.GraphEpochLog(base)
    stream = tcore.IngestStream(log=log, batches=batches, interval_ns=1e5)
    eng = tcore.MultiQueryEngine(tcore.XEON_E5_2660V4, pool_capacity=4, policy="scheduler")
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        rep = eng.run_sessions(
            lambda s, q: talg.PageRankExecutor(log.current(), mode="pull", max_iters=2, tol=0),
            sessions=2,
            queries_per_session=2,
            config=tcore.EngineConfig(dynamic=True, ingest=stream),
        )
    assert rep.epochs_published == 2
    with pytest.raises(TypeError):
        eng.run_sessions(
            lambda s, q: talg.PageRankExecutor(base, mode="pull", max_iters=1, tol=0),
            sessions=1,
            queries_per_session=1,
            dynamic=True,
        )


def test_ingest_requires_dynamic():
    base, batches = split_stream(tgraph, 7, base_fraction=0.8, n_batches=1)
    stream = tcore.IngestStream(log=tgraph.GraphEpochLog(base), batches=batches, interval_ns=1e5)
    with pytest.raises(ValueError):
        tcore.EngineConfig(ingest=stream)


def test_static_records_never_stamp_an_epoch():
    g = tgraph.rmat_graph(10, seed=3, device="cpu")
    eng = tcore.MultiQueryEngine(tcore.XEON_E5_2660V4, policy="scheduler")
    rep = eng.run_sessions(lambda s, q: talg.BFSExecutor(g, 0), sessions=2, queries_per_session=1)
    assert all(r.graph_epoch is None for r in rep.records)
    assert rep.ingest_events == [] and rep.epochs_published == 0
    assert rep.epoch_histogram() == {None: 2}
