"""The port's execution-backend seam (``repro_torch.core.backends``)
against the JAX package's, test for test with ``tests/test_backends.py``.
Where a run is deterministic (the modeled echo, a stub backend that reports
a fixed time) both engines run the same scenario and their reports must be
equal; where a run measures the host's clock (the inline and ``cuda``
backends), the reference's assertions are held on the port.

The reference's ``PallasBackend`` tests map to ``CudaBackend``. Here, on
the CPU, it runs the kernels' plain versions on a graph built on the CPU;
on the card the same tests run under the ``cuda`` marker in
``tests/test_torch_cuda.py`` (``test_cuda_backend_*_on_card``), with no
JAX. Already covered elsewhere, so not repeated here:

- ``test_resolve_backend_specs`` and ``test_backends_satisfy_protocol``:
  ``tests/test_torch_engine.py::test_resolve_backend_specs`` (names,
  the ``cuda`` backend, the protocol; the instance pass-through and the
  refusals are below);
- ``test_pallas_falls_back_inline_without_lowering``:
  ``tests/test_torch_engine.py::test_cuda_backend_inline_fallback_without_lowering``;
- ``test_pallas_results_stable_across_gang_widths``:
  ``tests/test_torch_engine.py::test_cuda_backend_pr_stable_across_gang_widths``.
"""
import dataclasses
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
import repro_torch.algorithms as talg  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from _torch_parity import both, packages, plain, port_graph, report_view  # noqa: E402
from _torch_bench_rows import one_torch_thread  # noqa: E402,F401  (autouse: one torch thread a test)


@pytest.fixture(scope="module")
def graphs(small_rmat):
    return {"jax": small_rmat, "torch": port_graph(small_rmat)}


@pytest.fixture(scope="module")
def graphs12(medium_rmat):
    return {"jax": medium_rmat, "torch": port_graph(medium_rmat)}


def _engine(core, backend=None, **kw):
    return core.MultiQueryEngine(core.XEON_E5_2660V4, policy="scheduler", backend=backend, **kw)


def _run_one(core, eng, ex):
    rec = core.QueryRecord(0, 0, ex.desc.name)
    eng.run_query(ex, rec)
    return rec


def _mixed_mk(alg, graph):
    hubs = np.argsort(-np.asarray(graph.out_degrees()))
    return lambda s, q: (alg.PageRankExecutor(graph, mode="pull", max_iters=3, tol=0) if s == 0
                         else alg.BFSExecutor(graph, int(hubs[s % 4])))


def _fused_cfg(core, **kw):
    return core.EngineConfig(steal=True, fuse=True, fusion=core.FusionConfig(hold_ns=2e4), **kw)


# ---------------- resolve + memoization ----------------

def test_resolve_backend_passes_instances_and_refuses_bad_specs():
    for name, (_, core) in packages().items():
        inst = core.InlineBackend()
        assert core.resolve_backend(inst) is inst
        assert isinstance(core.resolve_backend("modeled"), core.ModeledBackend)
        with pytest.raises(TypeError):
            core.resolve_backend(42)
    msgs = []
    for _, core in packages().values():
        with pytest.raises(ValueError, match="unknown execution backend") as err:
            core.resolve_backend("gpu")
        msgs.append(str(err.value).split(";")[0].split("(")[0])
    assert msgs[0] == msgs[1]


def test_prepare_is_memoized_per_executor_prep_pair(graphs):
    """The reference memoizes its plans; the port keeps none (below)."""
    alg, core = packages()["jax"]
    backend = core.ModeledBackend()
    ex = alg.PageRankExecutor(graphs["jax"], mode="pull", max_iters=2, tol=0)
    ex.start()
    prep = object()
    plan = backend.prepare(ex, prep)
    assert backend.prepare(ex, prep) is plan
    assert backend.prepare(ex, object()) is not plan


def test_plans_of_one_graph_share_one_handle(graphs):
    """Every plan is new, carries its own (executor, prep), and plans of one
    graph and lowering share the graph's one staged handle; executors
    without a lowering share the inline handle."""
    g = graphs["torch"]
    backend = tcore.CudaBackend()
    a, b = (talg.PageRankExecutor(g, mode="pull", max_iters=2, tol=0) for _ in range(2))
    p1, p2 = object(), object()
    plan = backend.prepare(a, p1)
    again, other = backend.prepare(a, p1), backend.prepare(b, p2)
    assert again is not plan and (again.executor, again.prep) == (a, p1)
    assert (other.executor, other.prep) == (b, p2)
    assert plan.handle is again.handle is other.handle and plan.handle.kind == "pr_pull"
    bfs = [backend.prepare(talg.BFSExecutor(g, s), p1).handle for s in (0, 1)]
    assert bfs[0] is bfs[1] and bfs[0].kind == "bfs" and bfs[0] is not plan.handle
    push = [backend.prepare(talg.PageRankExecutor(g, mode="push"), p1).handle for _ in range(2)]
    assert push[0] is push[1] and push[0].kind == "inline"
    for b in (tcore.ModeledBackend(), tcore.InlineBackend()):
        plan = b.prepare(a, p1)
        assert b.prepare(a, p1) is not plan and (plan.executor, plan.prep) == (a, p1)


@pytest.mark.parametrize("backend", ["modeled", "inline", "cuda"])
def test_backend_retains_no_executor(graphs, backend):
    """Once ``run_sessions`` returns and the caller drops its executors,
    nothing keeps them alive: not the backend, which lives on."""
    import gc
    import weakref

    b = tcore.resolve_backend(backend)
    eng = _engine(tcore, b, pool_capacity=16)
    mk, refs = _mixed_mk(talg, graphs["torch"]), []

    def make(s, q):
        ex = mk(s, q)
        refs.append(weakref.ref(ex))
        return ex

    rep = eng.run_sessions(make, sessions=16, queries_per_session=1,
                           config=tcore.EngineConfig(steal=True))
    assert len(rep.records) == len(refs) == 16
    gc.collect()
    assert eng.backend is b and all(r() is None for r in refs)


# ---------------- modeled echo ----------------

def test_modeled_backend_echoes_modeled_cost(graphs):
    def scenario(alg, core, pkg):
        return _run_one(core, _engine(core, "modeled"),
                        alg.PageRankExecutor(graphs[pkg], mode="pull", max_iters=3, tol=0))

    rec, _ = both(scenario)
    assert rec.modeled_ns > 0
    assert rec.measured_ns == rec.modeled_ns


def test_modeled_scheduling_identical_across_substrates(graphs):
    def run(backend):
        def scenario(alg, core, pkg):
            return _engine(core, backend).run_sessions(_mixed_mk(alg, graphs[pkg]), sessions=4, queries_per_session=1,
                                                       config=_fused_cfg(core))

        return scenario

    a, _ = both(run("modeled"), report_view)
    for name, (alg, core) in packages().items():
        b = run("inline")(alg, core, name)
        assert [r.modeled_ns for r in a.records] == [r.modeled_ns for r in b.records]
        assert [plain(r.traces) for r in a.records] == [plain(r.traces) for r in b.records]
        assert a.makespan_modeled_ns == b.makespan_modeled_ns


def test_modeled_echo_keeps_feedback_neutral(graphs):
    def scenario(alg, core, pkg):
        fb = core.CostFeedback()
        cfg = _fused_cfg(core, width_feedback=True)
        rep_fb = _engine(core, "modeled", feedback=fb).run_sessions(_mixed_mk(alg, graphs[pkg]), sessions=4,
                                                                    queries_per_session=1, config=cfg)
        rep_none = _engine(core, "modeled").run_sessions(_mixed_mk(alg, graphs[pkg]), sessions=4,
                                                         queries_per_session=1, config=cfg)
        return rep_fb, rep_none, fb

    (rep_fb, rep_none, fb), _ = both(scenario, lambda o: (report_view(o[0]), report_view(o[1]), plain(o[2])))
    assert fb.observations > 0 and fb.width_observations > 0
    for (algo, par) in list(fb._log_corr):
        assert fb.correction(algo, par) == pytest.approx(1.0)
    for (algo, w) in list(fb._log_width):
        assert fb.correction(algo, w >= 2, width=w) == pytest.approx(1.0)
        assert fb.width_ratio(algo, w) == pytest.approx(1.0)
    assert [r.modeled_ns for r in rep_fb.records] == [r.modeled_ns for r in rep_none.records]
    assert rep_fb.makespan_modeled_ns == rep_none.makespan_modeled_ns


# ---------------- CudaBackend lowerings (plain versions on the CPU) vs the references ----------------

def test_cuda_pagerank_pull_matches_reference(graphs):
    g, iters = graphs["torch"], 5
    ex = talg.PageRankExecutor(g, mode="pull", max_iters=iters, tol=0)
    rec = _run_one(tcore, _engine(tcore, "cuda"), ex)
    np.testing.assert_allclose(ex.result(), talg.pagerank_reference(g, iters=iters), rtol=2e-4, atol=1e-8)
    assert rec.edges == pytest.approx(g.num_edges * iters)
    assert rec.measured_ns > 0
    # the same modeled clock as the reference's modeled engine
    jrec = _run_one(jcore, _engine(jcore, "modeled"),
                    packages()["jax"][0].PageRankExecutor(graphs["jax"], mode="pull", max_iters=iters, tol=0))
    assert (rec.modeled_ns, rec.edges, plain(rec.traces)) == (jrec.modeled_ns, jrec.edges, plain(jrec.traces))


def test_cuda_bfs_matches_reference(graphs):
    g = graphs["torch"]
    src = int(np.argmax(g.out_degrees().numpy()))
    ex = talg.BFSExecutor(g, src)
    rec = _run_one(tcore, _engine(tcore, "cuda"), ex)
    assert np.array_equal(ex.result(), talg.bfs_reference(g, src))
    jalg = packages()["jax"][0]
    jex = jalg.BFSExecutor(graphs["jax"], src)
    _run_one(jcore, _engine(jcore, "modeled"), jex)
    assert np.array_equal(ex.result(), np.asarray(jex.result()))
    assert rec.measured_ns > 0


def test_cuda_degree_count_matches_reference(graphs):
    g = graphs["torch"]
    ex = talg.DegreeCountExecutor(g)
    _run_one(tcore, _engine(tcore, "cuda"), ex)
    ref = talg.degree_count_reference(g.src.numpy(), g.dst.numpy(), ex.num_counters)
    assert np.array_equal(ex.result(), ref)
    jalg = packages()["jax"][0]
    jex = jalg.DegreeCountExecutor(graphs["jax"])
    _run_one(jcore, _engine(jcore, "modeled"), jex)
    assert np.array_equal(ex.result(), np.asarray(jex.result()))


# ---------------- one launch per merged package range, at any gang width ----------------

_LOWERING_MK = {
    "pr_pull": lambda g, s: talg.PageRankExecutor(g, mode="pull", max_iters=3, tol=0),
    "bfs": lambda g, s: talg.BFSExecutor(g, int(np.argsort(-g.out_degrees().numpy())[s % 4])),
    "degree_count": lambda g, s: talg.DegreeCountExecutor(g),
}


def _forced_width_run(monkeypatch, g, kind, width, domains):
    """Two sessions of ``kind`` through a ``CudaBackend`` that hands every
    step to its lowering at gang width ``width``. Returns the results, for
    each lowered ``execute`` the kernel calls it made and its merged
    package ranges, and the iterations (levels, for BFS) the queries
    committed."""
    import repro_torch.kernels.degree_count.ops as dc_ops
    import repro_torch.kernels.spmv.ops as spmv_ops
    from repro_torch.algorithms.common import merge_ranges

    mod, name = (dc_ops, "count_into") if kind == "degree_count" else (spmv_ops, "spmv_tiles")
    real, seen = getattr(mod, name), []

    def counted(*args):
        seen.append(args[0])
        return real(*args)

    steps = []

    class ForcedWidth(tcore.CudaBackend):
        def execute(self, plan, step, modeled_ns=0.0):
            step = dataclasses.replace(step, workers=width)
            n0 = len(seen)
            ns = super().execute(plan, step, modeled_ns)
            steps.append((len(seen) - n0, len(merge_ranges(plan.prep.packages.bounds, step.batch))))
            return ns

    made = []

    def mk(s, q):
        made.append(_LOWERING_MK[kind](g, s))
        return made[-1]

    eng = tcore.MultiQueryEngine(tcore.XEON_E5_2660V4, pool_capacity=16, policy="scheduler")
    with monkeypatch.context() as m:
        m.setattr(mod, name, counted)
        rep = eng.run_sessions(mk, sessions=2, queries_per_session=1,
                               config=tcore.EngineConfig(steal=True, domains=domains, backend=ForcedWidth()))
    assert eng.pool.available == eng.pool.capacity
    return [ex.result() for ex in made], steps, sum(r.iterations for r in rep.records)


@pytest.mark.parametrize("width", [1, 4, 19, 56])
@pytest.mark.parametrize("kind,domains", [("pr_pull", 1), ("bfs", 1), ("degree_count", 1), ("pr_pull", 2)])
def test_cuda_backend_one_launch_per_merged_range(graphs, monkeypatch, kind, domains, width):
    """Every merged package range of a step is one kernel call (``spmv_tiles``,
    or ``count_into`` for degree counts), whatever the step's gang width, and
    the answers equal width 1's to the bit; BFS makes at most one call a
    step, one for each level committed; two locality domains change
    neither."""
    g = graphs["torch"]
    got, steps, levels = _forced_width_run(monkeypatch, g, kind, width, domains)
    want, _, _ = _forced_width_run(monkeypatch, g, kind, 1, domains)
    assert steps
    if kind == "bfs":
        assert all(calls <= 1 for calls, _ in steps)
        assert sum(calls for calls, _ in steps) == levels
    else:
        assert all(calls == ranges for calls, ranges in steps)
    for a, b in zip(got, want):
        assert torch.equal(torch.from_numpy(a), torch.from_numpy(b))


def test_cuda_backend_bfs_sweeps_once_per_level(graphs12):
    """Four contending BFS sessions cut their levels into several merged
    ranges; each level's first range sweeps for the whole frontier and the
    others launch nothing (``bfs.level_sweeps`` and ``bfs.ranges_served``),
    the levels equal the oracle's and ``edges_traversed`` equals an
    ``InlineBackend`` run's to the bit."""
    from repro_torch.core import tracing

    g = graphs12["torch"]
    hubs = np.argsort(-g.out_degrees().numpy())
    made = []

    def mk(s, q):
        made.append(talg.BFSExecutor(g, int(hubs[s])))
        return made[-1]

    eng = tcore.MultiQueryEngine(tcore.XEON_E5_2660V4, pool_capacity=8, policy="scheduler")
    rec = tracing.start()
    try:
        rep = eng.run_sessions(mk, sessions=4, queries_per_session=1,
                               config=tcore.EngineConfig(steal=True, backend="cuda"))
    finally:
        tracing.stop()
    sweeps, served = rec.counters.get("bfs.level_sweeps", 0), rec.counters.get("bfs.ranges_served", 0)
    assert served > 0 and sweeps == sum(r.iterations for r in rep.records)
    for ex in made:
        np.testing.assert_array_equal(ex.result(), talg.bfs_reference(g, ex.source))
        inline = talg.BFSExecutor(g, ex.source)
        _run_one(tcore, _engine(tcore, "inline"), inline)
        assert ex.edges_traversed() == inline.edges_traversed()


class _NewTensorsOfSize(torch.utils._python_dispatch.TorchDispatchMode):
    """Records the ops that make a tensor of ``n`` elements whose storage
    none of their inputs holds (views and in-place results alias an input),
    except while ``paused``."""

    def __init__(self, n):
        super().__init__()
        self.n, self.paused, self.made = n, False, []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not self.paused:
            held = {t.untyped_storage().data_ptr()
                    for t in torch.utils._pytree.tree_leaves((args, kwargs)) if isinstance(t, torch.Tensor)}
            for t in torch.utils._pytree.tree_leaves(out):
                if (isinstance(t, torch.Tensor) and t.numel() == self.n
                        and t.untyped_storage().data_ptr() not in held):
                    self.made.append(str(func))
        return out


@pytest.mark.parametrize("domains", [1, 2])
@pytest.mark.parametrize("width", [1, 4, 19, 56])
def test_cuda_backend_pr_pull_applies_its_range_in_place(graphs12, monkeypatch, width, domains):
    """pr_pull applies its range in place: four PageRank-pull sessions at a
    forced gang width give ranks and ``edges_traversed`` equal to the bit
    to the earlier seam's (the unpadding into a new ``[V]`` vector and a
    full add, ``tests/_torch_pull.py``); every mid-iteration ``execute``
    leaves the accumulator's storage where it was and its lanes outside the
    step's ranges bitwise untouched, and, outside ``spmv_tiles``, makes no
    tensor of V elements."""
    import repro_torch.kernels.spmv.ops as spmv_ops
    from _torch_pull import UnpaddingCudaBackend
    from repro_torch.algorithms.common import merge_ranges

    g = graphs12["torch"]
    nv = g.num_vertices
    watch = _NewTensorsOfSize(nv)
    real = spmv_ops.spmv_tiles

    def unwatched(*args):
        watch.paused = True
        try:
            return real(*args)
        finally:
            watch.paused = False

    mid = []

    class Watched(tcore.CudaBackend):
        def execute(self, plan, step, modeled_ns=0.0):
            step = dataclasses.replace(step, workers=width)
            ex = plan.executor
            acc, it = ex._acc, ex._iter
            ptr = acc.data_ptr()
            before = acc.clone()
            watch.made = []
            with watch:
                ns = super().execute(plan, step, modeled_ns)
            if ex._iter == it:  # the step did not end the iteration
                outside = torch.ones(nv, dtype=torch.bool)
                for lo, hi in merge_ranges(plan.prep.packages.bounds, step.batch):
                    outside[lo:hi] = False
                assert ex._acc is acc and acc.data_ptr() == ptr
                assert torch.equal(ex._acc.view(torch.int32)[outside], before.view(torch.int32)[outside])
                assert watch.made == [], watch.made
                mid.append(int(outside.sum()))
            return ns

    def run(backend):
        made = []

        def mk(s, q):
            made.append(talg.PageRankExecutor(g, mode="pull", max_iters=3, tol=0))
            return made[-1]

        eng = tcore.MultiQueryEngine(tcore.XEON_E5_2660V4, pool_capacity=16, policy="scheduler")
        eng.run_sessions(mk, sessions=4, queries_per_session=1,
                         config=tcore.EngineConfig(steal=True, domains=domains, backend=backend))
        assert eng.pool.available == eng.pool.capacity
        return [(ex.result(), ex.edges_traversed()) for ex in made]

    with monkeypatch.context() as m:
        m.setattr(spmv_ops, "spmv_tiles", unwatched)
        got = run(Watched())
    want = run(UnpaddingCudaBackend())
    assert mid and max(mid) > 0  # mid-iteration steps that left lanes alone
    for (rank, edges), (rank0, edges0) in zip(got, want):
        assert np.array_equal(rank.view(np.int32), rank0.view(np.int32))
        assert edges == edges0 == g.num_edges * 3


# ---------------- measured time reaches the feedback loop ----------------

def _skew_mk(alg, graph):
    hubs = np.argsort(-np.asarray(graph.out_degrees()))
    return lambda s, q: (alg.PageRankExecutor(graph, mode="pull", max_iters=6, tol=0) if s == 0
                         else alg.BFSExecutor(graph, int(hubs[s % 8])))


def test_backend_measurements_reach_feedback_stolen_path(graphs12):
    fb = tcore.CostFeedback()
    eng = tcore.MultiQueryEngine(tcore.XEON_E5_2660V4, pool_capacity=16, policy="scheduler", feedback=fb,
                                 backend="inline")
    rep = eng.run_sessions(_skew_mk(talg, graphs12["torch"]), sessions=8, queries_per_session=1,
                           config=tcore.EngineConfig(steal=True, width_feedback=True))
    assert rep.total_stolen > 0
    assert fb.observations == sum(r.iterations for r in rep.records)
    assert fb.width_observations > 0
    assert any(r.measured_ns != r.modeled_ns for r in rep.records)


def test_backend_measurements_reach_feedback_fused_path(graphs12):
    fb = tcore.CostFeedback()
    eng = tcore.MultiQueryEngine(tcore.XEON_E5_2660V4, pool_capacity=8, policy="scheduler", feedback=fb,
                                 backend="inline")
    g = graphs12["torch"]
    rep = eng.run_sessions(lambda s, q: talg.PageRankExecutor(g, mode="pull", max_iters=3, tol=0), sessions=4,
                           queries_per_session=1, config=tcore.EngineConfig(fuse=True, width_feedback=True))
    assert rep.total_fused > 0
    assert fb.width_observations > 0
    assert all(r.measured_ns > 0 for r in rep.records)


def test_cuda_measurements_populate_width_table(graphs):
    fb = tcore.CostFeedback()
    eng = tcore.MultiQueryEngine(tcore.XEON_E5_2660V4, pool_capacity=8, policy="scheduler", feedback=fb,
                                 backend="cuda")
    rep = eng.run_sessions(_mixed_mk(talg, graphs["torch"]), sessions=2, queries_per_session=1,
                           config=tcore.EngineConfig(steal=True, width_feedback=True))
    assert fb.width_observations > 0
    assert all(r.measured_ns > 0 for r in rep.records)


# ---------------- prepare is outside the measured window ----------------

def _stub(core):
    class SlowPrepareStub:
        """A substrate whose preparation takes ~2 ms, far above any step,
        and whose execute reports a fixed 7 ns."""

        name = "slow-prepare-stub"

        def __init__(self):
            self.prepare_calls = 0
            self.execute_calls = 0

        def prepare(self, executor, prep):
            self.prepare_calls += 1
            time.sleep(0.002)
            return core.DevicePlan(executor, prep)

        def execute(self, plan, step, modeled_ns=0.0):
            self.execute_calls += 1
            plan.executor.run_packages(step.batch, plan.prep.packages,
                                       step.workers if step.mode == "parallel" else 1,
                                       parallel=step.mode == "parallel")
            return 7.0

    return SlowPrepareStub()


def test_prepare_cost_never_pollutes_measured_time(graphs):
    def scenario(alg, core, pkg):
        stub = _stub(core)
        rec = _run_one(core, _engine(core, stub), alg.PageRankExecutor(graphs[pkg], mode="pull", max_iters=3, tol=0))
        return rec, stub.prepare_calls, stub.execute_calls

    rec, prepares, executes = both(scenario)[0]
    assert prepares > 0 and executes > 0
    assert rec.measured_ns == pytest.approx(7.0 * executes)


def test_custom_backend_instance_via_engine_config(graphs):
    def scenario(alg, core, pkg):
        stub = _stub(core)
        eng = _engine(core, "modeled")
        default = eng.backend
        rep = eng.run_sessions(_mixed_mk(alg, graphs[pkg]), sessions=2, queries_per_session=1,
                               config=core.EngineConfig(backend=stub))
        assert eng.backend is default
        return rep, stub.execute_calls

    rep, executes = both(scenario, lambda o: (report_view(o[0]), o[1]))[0]
    assert executes > 0
    for r in rep.records:
        assert r.measured_ns > 0
        assert r.measured_ns % 7.0 == pytest.approx(0.0, abs=1e-9)


# ---------------- config-only surface ----------------

def test_run_sessions_rejects_legacy_kwargs(graphs):
    def scenario(alg, core, pkg):
        eng = _engine(core)
        with pytest.raises(TypeError):
            eng.run_sessions(_mixed_mk(alg, graphs[pkg]), sessions=2, queries_per_session=1, steal=True)
        return eng.run_sessions(_mixed_mk(alg, graphs[pkg]), sessions=2, queries_per_session=1,
                                config=core.EngineConfig(steal=True))

    rep, _ = both(scenario, report_view)
    assert len(rep.records) == 2
