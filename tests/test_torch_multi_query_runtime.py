"""The port's unified multi-query runtime (``run_query``/``run_sessions``,
the §4.3 protocol under the discrete-event loop, admission, open-loop
arrivals, priorities, the report, and the dynamic-graph writer/reader
stress) against the JAX package's, test for test with
``tests/test_multi_query_runtime.py``. Each scenario runs in both
packages: records, traces, reports (utilization, in-flight, steal, fusion,
preemption and ingest events), admission decisions, pool ledgers and
scheduler steps must be equal, and the reference's assertions hold on the
port."""
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.graph as jgraph  # noqa: E402
import repro_torch.graph as tgraph  # noqa: E402
from _torch_parity import both, packages, plain, port_graph, report_view  # noqa: E402
from _torch_bench_rows import one_torch_thread  # noqa: E402,F401  (autouse: one torch thread a test)

GRAPH_PKGS = {"jax": jgraph, "torch": tgraph}


@pytest.fixture(scope="module")
def graphs(medium_rmat):
    return {"jax": medium_rmat, "torch": port_graph(medium_rmat)}


def _mk_pr(alg, graph, max_iters=3):
    return lambda s, q: alg.PageRankExecutor(graph, mode="pull", max_iters=max_iters, tol=0)


def _sessions(graphs, *, pool=None, sessions, queries=1, mk=None, engine_kw=None, config=None, check_pool=True):
    """``run_sessions`` in both engines, reports equal; returns the port's."""

    def scenario(alg, core, pkg):
        kw = dict(engine_kw or {})
        if pool is not None:
            kw["pool_capacity"] = pool
        eng = core.MultiQueryEngine(core.XEON_E5_2660V4, policy=kw.pop("policy", "scheduler"), **kw)
        rep = eng.run_sessions((mk or (lambda a, g: _mk_pr(a, g)))(alg, graphs[pkg]), sessions=sessions,
                               queries_per_session=queries, config=config(core) if config else None)
        if check_pool:
            assert eng.pool.available == eng.pool.capacity
        return rep

    return both(scenario, report_view)[0]


# ---------------- one shared iteration path ----------------

def _query_and_session(graphs, policy):
    def scenario(alg, core, pkg):
        rec = core.QueryRecord(0, 0, "pr")
        core.MultiQueryEngine(core.XEON_E5_2660V4, policy=policy).run_query(
            alg.PageRankExecutor(graphs[pkg], mode="pull", max_iters=5, tol=0), rec)
        rep = core.MultiQueryEngine(core.XEON_E5_2660V4, policy=policy).run_sessions(
            _mk_pr(alg, graphs[pkg], max_iters=5), sessions=1, queries_per_session=1)
        return rec, rep

    return both(scenario, lambda o: (plain(o[0]), report_view(o[1])))[0]


@pytest.mark.parametrize("policy", ["scheduler", "sequential", "simple"])
def test_run_query_and_single_session_traces_identical(graphs, policy):
    rec, rep = _query_and_session(graphs, policy)
    assert len(rep.records) == 1
    assert rec.traces == rep.records[0].traces
    assert rec.iterations == rep.records[0].iterations
    assert rec.modeled_ns == pytest.approx(rep.records[0].modeled_ns)
    assert rec.edges == rep.records[0].edges


def test_single_session_throughput_matches_run_query(graphs):
    rec, rep = _query_and_session(graphs, "scheduler")
    assert rep.throughput_modeled() == pytest.approx(rec.edges / (rec.modeled_ns * 1e-9), rel=0.10)


# ---------------- full §4.3 protocol under saturation ----------------

def test_saturated_pool_shows_fallback_and_early_release(graphs):
    rep = _sessions(graphs, pool=5, sessions=16)
    traces = [tr for r in rep.records for tr in r.traces]
    assert sum(any(run.mode == "sequential" for run in tr.runs) for tr in traces) > 0
    assert any(tr.released_early for tr in traces)


def test_admission_keeps_inflight_below_cap(graphs):
    rep = _sessions(graphs, pool=4, sessions=16)
    assert rep.admission_cap == 4
    assert 0 < rep.max_inflight <= 4
    assert len(rep.records) == 16


def test_admission_cap_derives_from_target_share():
    def scenario(alg, core, pkg):
        ctrl, pool = core.AdmissionController(target_share=2), core.WorkerPool(8)
        return [ctrl.cap(pool), core.AdmissionController(target_share=1, max_inflight=3).cap(pool),
                [ctrl.try_admit(pool) for _ in range(6)]]

    assert both(scenario)[0] == [4, 3, [True] * 4 + [False] * 2]


def test_admission_cap_follows_measured_efficiency_frontier():
    def scenario(alg, core, pkg):
        pool, ctrl = core.WorkerPool(16), core.AdmissionController(target_share=4)
        seen = [ctrl.cap(pool)]
        for fn in (lambda: 2, lambda: 8, lambda: 0, None):
            ctrl.frontier_fn = fn
            seen.append(ctrl.cap(pool))
        narrow = core.AdmissionController(target_share=4, max_inflight=5)
        narrow.frontier_fn = lambda: 1
        return seen + [narrow.cap(pool)]

    assert both(scenario)[0] == [4, 8, 4, 16, 4, 5]


def test_adaptive_admission_is_inert_under_neutral_feedback(graphs):
    def run(adaptive):
        def scenario(alg, core, pkg):
            eng = core.MultiQueryEngine(core.XEON_E5_2660V4, pool_capacity=4, policy="scheduler",
                                        feedback=core.CostFeedback())
            rep = eng.run_sessions(_mk_pr(alg, graphs[pkg]), sessions=8, queries_per_session=1,
                                   config=core.EngineConfig(width_feedback=True, adaptive_admission=adaptive))
            assert eng.admission.frontier_fn is None
            return rep

        return both(scenario, report_view)[0]

    off, on = run(False), run(True)
    assert [r.modeled_ns for r in off.records] == [r.modeled_ns for r in on.records]
    assert off.makespan_modeled_ns == on.makespan_modeled_ns
    assert on.admission_cap == off.admission_cap == 4


def test_adaptive_admission_requires_width_feedback(graphs):
    def scenario(alg, core, pkg):
        eng = core.MultiQueryEngine(core.XEON_E5_2660V4, pool_capacity=4, policy="scheduler")
        rep = eng.run_sessions(_mk_pr(alg, graphs[pkg]), sessions=6, queries_per_session=1,
                               config=core.EngineConfig(adaptive_admission=True))
        assert eng.admission.frontier_fn is None
        return rep

    assert len(both(scenario, report_view)[0].records) == 6


def _names(waiters, named):
    return [next(k for k, v in named.items() if v is w) for w in waiters]


def test_admission_waiters_pop_by_priority():
    def scenario(alg, core, pkg):
        ctrl, pool = core.AdmissionController(max_inflight=1), core.WorkerPool(4)
        first = ctrl.try_admit(pool)
        named = {"low_a": SimpleNamespace(priority=0), "low_b": SimpleNamespace(priority=0),
                 "high": SimpleNamespace(priority=1)}
        for w in named.values():
            ctrl.enqueue(w)
        return [first] + [_names(ctrl.release(pool), named) for _ in range(3)]

    assert both(scenario)[0] == [True, ["high"], ["low_a"], ["low_b"]]


def test_resize_clamps_priority_reserve():
    def scenario(alg, core, pkg):
        pool = core.WorkerPool(8, high_priority_reserve=4)
        pool.resize(2)
        seen = [pool.high_priority_reserve, pool.capacity, pool.request(2, priority=0)]
        with pytest.raises(ValueError) as err:
            pool.resize(0)
        return seen + [str(err.value)]

    reserve, cap, granted, _ = both(scenario)[0]
    assert reserve < cap and granted >= 1


# ---------------- pool / admission accounting regressions ----------------

def test_arrival_queues_behind_waiting_higher_priority():
    def scenario(alg, core, pkg):
        ctrl, pool = core.AdmissionController(), core.WorkerPool(2)
        full = [ctrl.try_admit(pool), ctrl.try_admit(pool)]
        named = {"high": SimpleNamespace(priority=1), "low": SimpleNamespace(priority=0)}
        ctrl.enqueue(named["high"])
        pool.resize(6)
        return full, _names(ctrl.submit(named["low"], pool), named)

    full, admitted = both(scenario)[0]
    assert full == [True, True]
    assert admitted[0] == "high" and "low" in admitted


def test_release_drains_all_eligible_waiters():
    def scenario(alg, core, pkg):
        ctrl, pool = core.AdmissionController(), core.WorkerPool(2)
        full = [ctrl.try_admit(pool), ctrl.try_admit(pool)]
        named = {f"w{i}": SimpleNamespace(priority=0) for i in range(3)}
        for w in named.values():
            ctrl.enqueue(w)
        pool.resize(8)
        return full, _names(ctrl.release(pool), named), ctrl.inflight, ctrl.has_waiters

    assert both(scenario)[0] == ([True, True], ["w0", "w1", "w2"], 4, False)


def _bounds(core, t_min=2, t_max=2, n_packages=4):
    return core.ThreadBounds(t_min=t_min, t_max=t_max, n_packages=n_packages, v_min_parallel=10, parallel=True,
                             cost_seq_ns=1e6, cost_par_ns=2e5)


def _step(s):
    return None if s is None else (s.mode, [int(p) for p in s.batch], s.workers)


def test_zero_grant_step_stalls_instead_of_phantom_execution():
    def scenario(alg, core, pkg):
        pool = core.WorkerPool(2)
        hold = pool.request(2)
        b = _bounds(core)
        srun = core.PackageScheduler(pool).begin(core.make_packages(np.full(100, 4), b, variance_ratio=1.0), b)
        stalled = _step(srun.next_step())
        seen = [stalled, pool.in_use, pool.capacity, srun.done]
        pool.release(hold)
        step = _step(srun.next_step())
        seen += [step, pool.in_use]
        srun.close()
        return seen + [pool.available]

    stalled, in_use, cap, done, step, in_use2, available = both(scenario)[0]
    assert stalled == ("stalled", [], 0)
    assert in_use <= cap and not done
    assert step[0] in ("parallel", "sequential") and step[2] >= 1
    assert in_use2 >= step[2] and available == cap


def test_sync_run_on_drained_pool_raises():
    msgs = []
    for _, core in packages().values():
        pool = core.WorkerPool(2)
        pool.request(2)
        b = _bounds(core)
        with pytest.raises(RuntimeError, match="hold >= 1 worker") as err:
            core.PackageScheduler(pool).run(core.make_packages(np.full(100, 4), b, variance_ratio=1.0), b,
                                            lambda *a: None, lambda *a: None)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_stalled_sessions_complete_without_oversubscription(graphs):
    rep = _sessions(graphs, pool=2, sessions=8)
    assert len(rep.records) == 8
    assert all(r.finished_ns > 0 for r in rep.records)
    runs = [run for r in rep.records for tr in r.traces for run in tr.runs]
    assert runs and all(run.workers >= 1 for run in runs)
    assert all(0 <= u <= 2 for _, u in rep.utilization)


def test_resize_shrink_keeps_outstanding_grant_debt():
    def scenario(alg, core, pkg):
        pool = core.WorkerPool(8)
        seen = [pool.request(6)]
        pool.resize(4)
        seen += [pool.in_use, pool.shrink_debt, pool.available, pool.request(1)]
        pool.release(3)
        seen += [pool.in_use, pool.shrink_debt, pool.available, pool.request(2)]
        pool.release(4)
        return seen + [pool.available, pool.capacity]

    assert both(scenario)[0] == [6, 6, 2, 0, 0, 3, 0, 1, 1, 4, 4]


def test_parallel_phase_releases_unusable_surplus():
    def scenario(alg, core, pkg):
        pool = core.WorkerPool(16)
        taken = pool.request(10)
        b = _bounds(core, t_min=2, t_max=8, n_packages=8)
        srun = core.PackageScheduler(pool).begin(core.make_packages(np.full(200, 4), b, variance_ratio=1.0), b)
        seen = [_step(srun.next_step()), pool.available]
        srun.close()
        pool.release(taken)
        return seen + [pool.available]

    step, available, after = both(scenario)[0]
    assert step[0] == "parallel" and step[2] == 4
    assert available == 2 and after == 16


def test_executor_exception_does_not_leak_engine_state(graphs):
    class BoomExecutor:
        def __init__(self, inner):
            self.inner = inner
            self.desc = inner.desc

        def __getattr__(self, name):
            return getattr(self.inner, name)

        def run_packages(self, *a, **kw):
            raise RuntimeError("boom")

    def scenario(alg, core, pkg):
        g = graphs[pkg]
        eng = core.MultiQueryEngine(core.XEON_E5_2660V4, pool_capacity=4, policy="scheduler")
        with pytest.raises(RuntimeError, match="boom"):
            eng.run_sessions(lambda s, q: BoomExecutor(alg.PageRankExecutor(g, mode="pull", max_iters=2, tol=0)),
                             sessions=6, queries_per_session=1)
        state = (eng.pool.available, eng.pool.capacity, eng.admission.inflight)
        return state, eng.run_sessions(_mk_pr(alg, g), sessions=4, queries_per_session=1)

    (state, rep), _ = both(scenario, lambda o: (o[0], report_view(o[1])))
    assert state[0] == state[1] and state[2] == 0
    assert len(rep.records) == 4 and rep.total_edges > 0


# ---------------- open-loop arrivals ----------------

def test_poisson_arrivals_deterministic_and_positive():
    def scenario(alg, core, pkg):
        a = core.PoissonArrivals(rate_per_s=1e4, seed=42)
        return a.times_ns(100), a.times_ns(100), core.PoissonArrivals(rate_per_s=1e4, seed=43).times_ns(100)

    t1, t2, t3 = both(scenario)[0]
    assert np.array_equal(t1, t2)
    assert (np.diff(t1) > 0).all() and t1[0] > 0
    assert not np.array_equal(t1, t3)


def test_open_loop_arrivals_shift_latency(graphs):
    rep = _sessions(graphs, pool=8, sessions=6,
                    config=lambda core: core.EngineConfig(arrivals=core.PoissonArrivals(rate_per_s=5_000.0, seed=1)))
    from repro_torch.core import PoissonArrivals

    times = PoissonArrivals(rate_per_s=5_000.0, seed=1).times_ns(6)
    assert sorted(r.submitted_ns for r in rep.records) == pytest.approx(sorted(times))
    assert rep.makespan_modeled_ns >= times.max()
    assert all(r.finished_ns >= r.submitted_ns for r in rep.records)


# ---------------- priorities ----------------

def test_high_priority_reserve_honoured():
    def scenario(alg, core, pkg):
        pool = core.WorkerPool(8, high_priority_reserve=2)
        seen = [pool.request(8, priority=0)]
        pool.release(6)
        seen.append(pool.request(8, priority=1))
        pool.release(8)
        return seen

    assert both(scenario)[0] == [6, 8]


def test_high_priority_session_gets_more_parallelism(graphs):
    rep = _sessions(graphs, pool=4, sessions=8, engine_kw=dict(high_priority_reserve=2),
                    config=lambda core: core.EngineConfig(priorities=lambda sid: 1 if sid == 0 else 0))
    by_prio = {0: [], 1: []}
    for r in rep.records:
        by_prio[r.priority].append(r.parallel_iterations)
    assert by_prio[1]
    assert max(by_prio[1]) >= max(by_prio[0])


# ---------------- extended report ----------------

def test_report_latency_percentiles_and_utilization(graphs):
    rep = _sessions(graphs, pool=4, sessions=8, queries=2)
    pct = rep.latency_percentiles()
    assert 0 < pct["p50"] <= pct["p95"] <= pct["p99"]
    per_session = rep.latency_percentiles_by_session()
    assert set(per_session) == set(range(8))
    assert all(p["p50"] > 0 for p in per_session.values())
    assert 0.0 < rep.mean_utilization() <= 1.0
    assert all(0 <= u <= 4 for _, u in rep.utilization)
    ts = [t for t, _ in rep.utilization]
    assert ts == sorted(ts)


def test_feedback_observed_in_run_sessions(graphs):
    def scenario(alg, core, pkg):
        fb = core.CostFeedback(alpha=0.5)
        rep = core.MultiQueryEngine(core.XEON_E5_2660V4, policy="scheduler", feedback=fb).run_sessions(
            _mk_pr(alg, graphs[pkg]), sessions=3, queries_per_session=1)
        return rep, fb

    rep, fb = both(scenario, lambda o: (report_view(o[0]), plain(o[1])))[0]
    total_iters = sum(r.iterations for r in rep.records)
    assert total_iters > 0
    assert fb.observations == total_iters


def test_bfs_sessions_still_complete(graphs):
    rep = _sessions(graphs, pool=4, sessions=6, queries=2,
                    mk=lambda alg, g: lambda s, q: alg.BFSExecutor(g, (s * 37 + q) % g.num_vertices))
    assert len(rep.records) == 12
    assert rep.total_edges > 0
    assert all(r.finished_ns > 0 for r in rep.records)


# ---------------- dynamic graphs: writer/reader interleaving stress ----------------

def _dyn_setup(pkg, core, scale=11, seed=3, base_fraction=0.85, n_batches=4, interval_ns=2e5):
    g = GRAPH_PKGS[pkg]
    src, dst = g.rmat_edges(scale, seed=seed)
    cut = int(src.size * base_fraction)
    kw = {"device": "cpu"} if pkg == "torch" else {}
    base = g.build_graph(src[:cut], dst[:cut], 2 ** scale, name="dyn_stress", **kw)
    log = g.GraphEpochLog(base)
    parts = np.array_split(np.arange(cut, src.size), n_batches)
    stream = core.IngestStream(log=log, batches=[(src[i], dst[i]) for i in parts], interval_ns=interval_ns)
    return base, log, stream


def _guard_pool(pool):
    """Assert the ledger invariant after every pool transition; returns the
    transition counter."""
    orig_request, orig_release = pool.request, pool.release
    calls = {"n": 0}

    def request(n, **kw):
        got = orig_request(n, **kw)
        assert pool.in_use <= pool.capacity + pool.shrink_debt
        calls["n"] += 1
        return got

    def release(n, **kw):
        out = orig_release(n, **kw)
        assert pool.in_use <= pool.capacity + pool.shrink_debt
        calls["n"] += 1
        return out

    pool.request = request
    pool.release = release
    return calls


def _conserved_on_pinned(alg, rep, pinned, max_iters):
    for r in rep.records:
        ex = pinned[(r.session, r.query)]
        assert r.finished_ns > 0
        assert r.graph_epoch == ex.graph.epoch
        if isinstance(ex, alg.PageRankExecutor):
            assert r.edges == pytest.approx((max_iters or ex.max_iters) * ex.graph.num_edges)
        else:
            assert np.array_equal(np.asarray(ex.result()), np.asarray(alg.bfs_reference(ex.graph, ex.source)))


def _stress(mk, config, pool, sessions, queries, max_iters, **setup):
    """A writer/reader stress run in both engines with the pool guarded and
    conservation checked on each package's pinned snapshots; reports equal.
    Returns the port's report."""

    def scenario(alg, core, pkg):
        _, log, stream = _dyn_setup(pkg, core, **setup)
        eng = core.MultiQueryEngine(core.XEON_E5_2660V4, pool_capacity=pool, policy="scheduler")
        calls = _guard_pool(eng.pool)
        pinned = {}

        def make(s, q):
            ex = mk(alg, log.current(), s, q)
            pinned[(s, q)] = ex
            return ex

        rep = eng.run_sessions(make, sessions=sessions, queries_per_session=queries,
                               config=config(core, stream))
        assert calls["n"] > 0
        _conserved_on_pinned(alg, rep, pinned, max_iters)
        assert eng.pool.available == eng.pool.capacity
        return rep

    return both(scenario, report_view)[0]


def test_writer_publishes_mid_fused_gang_conservation():
    rep = _stress(lambda alg, g, s, q: alg.PageRankExecutor(g, mode="pull", max_iters=3, tol=0),
                  lambda core, stream: core.EngineConfig(dynamic=True, ingest=stream, fuse=True,
                                                         fusion=core.FusionConfig(hold_ns=5e4),
                                                         arrivals=[i * 1.0e5 for i in range(6)]),
                  pool=4, sessions=6, queries=2, max_iters=3, scale=11, n_batches=5, interval_ns=2.5e5)
    assert rep.fusion_events
    assert rep.epochs_published == 5
    t_ingest = [t for t, _, _ in rep.ingest_events]
    assert min(t for t, *_ in rep.fusion_events) < max(t_ingest)
    assert len({r.graph_epoch for r in rep.records}) >= 2


def test_writer_publishes_mid_steal_conservation():
    def mk(alg, g, s, q):
        if s < 2:
            return alg.PageRankExecutor(g, mode="pull", max_iters=5, tol=0)
        return alg.BFSExecutor(g, int(np.argsort(-np.asarray(g.out_degrees()))[s % 8]))

    rep = _stress(mk, lambda core, stream: core.EngineConfig(dynamic=True, ingest=stream, steal=True,
                                                             arrivals=[0.0, 0.0, 2e4, 2e4, 4e4, 4e4]),
                  pool=8, sessions=6, queries=2, max_iters=5, scale=11, n_batches=5, interval_ns=1.2e5)
    assert rep.steal_events
    assert rep.epochs_published == 5
    t_ingest = [t for t, _, _ in rep.ingest_events]
    assert min(t for t, *_ in rep.steal_events) < max(t_ingest)
    assert max(t for t, *_ in rep.steal_events) > min(t_ingest)


def test_preemption_defuse_resumes_members_on_pinned_snapshot():
    rep = _stress(lambda alg, g, s, q: alg.PageRankExecutor(g, mode="pull", max_iters=4 if s < 4 else 2, tol=0),
                  lambda core, stream: core.EngineConfig(
                      dynamic=True, ingest=stream, fuse=True,
                      governor=core.CapacityGovernor(p_min=8, p_max=8, window_ns=1e5, cooldown_ns=1e12, preempt=True),
                      priorities=[0, 0, 0, 0, 1], arrivals=[0.0, 0.0, 0.0, 0.0, 2e5]),
                  pool=8, sessions=5, queries=1, max_iters=None, scale=12, n_batches=4, interval_ns=2.5e5)
    assert rep.fusion_events
    assert rep.preemptions
    assert rep.epochs_published == 4
    assert sum(tr.preempted for r in rep.records for tr in r.traces) >= 1
