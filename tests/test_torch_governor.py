"""The port's elastic capacity governor, admission quotas, preemption
fences and report guards against the JAX package's, test for test with
``tests/test_governor.py``. Each scenario runs in both packages: pool
reserves, hook calls, admission decisions, fence states and whole engine
reports (records, resize events, capacity timelines, preemptions) must be
equal, and the reference's assertions hold on the port."""
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.graph import rmat_graph  # noqa: E402
from _torch_parity import both, packages, port_graph, report_view  # noqa: E402
from _torch_bench_rows import one_torch_thread  # noqa: E402,F401  (autouse: one torch thread a test)


@pytest.fixture(scope="module")
def graphs(medium_rmat):
    return {"jax": medium_rmat, "torch": port_graph(medium_rmat)}


def _mk_pr(alg, graph, max_iters=3):
    return lambda s, q: alg.PageRankExecutor(graph, mode="pull", max_iters=max_iters, tol=0)


def _run(graphs, *, pool, sessions, queries=1, mk=None, admission=None, governor=None, **cfg):
    """The run in both engines, reports equal; returns the port's report.
    ``mk``, ``admission`` and ``governor`` are factories of ``(alg, core,
    graph)`` / ``(core)``."""

    def scenario(alg, core, pkg):
        g = graphs[pkg]
        kw = {} if admission is None else {"admission": admission(core)}
        eng = core.MultiQueryEngine(core.XEON_E5_2660V4, pool_capacity=pool, policy="scheduler", **kw)
        rep = eng.run_sessions((mk or (lambda a, c, gr: _mk_pr(a, gr)))(alg, core, g), sessions=sessions,
                               queries_per_session=queries,
                               config=core.EngineConfig(governor=governor(core) if governor else None, **cfg))
        assert eng.pool.available == eng.pool.capacity
        return rep

    return both(scenario, report_view)[0]


def _raises_alike(exc, make):
    msgs = []
    for _, core in packages().values():
        with pytest.raises(exc) as err:
            make(core)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


# ---------------- config validation ----------------

def test_governor_config_validation():
    for kw in (dict(p_min=0, p_max=4), dict(p_min=8, p_max=4), dict(p_min=1, p_max=4, grow_util=0.2, shrink_util=0.5),
               dict(p_min=1, p_max=4, window_ns=0)):
        _raises_alike(ValueError, lambda core, kw=kw: core.GovernorConfig(**kw))
    with pytest.raises(TypeError):
        from repro_torch.core import CapacityGovernor, GovernorConfig

        CapacityGovernor(GovernorConfig(p_min=1, p_max=4), p_min=1)


# ---------------- resize restores the requested reserve ----------------

def test_resize_restores_reserve_across_shrink_grow_cycles():
    def scenario(alg, core, pkg):
        pool = core.WorkerPool(8, high_priority_reserve=4)
        seen = []
        for cap in (2, 8, 3, 16):
            pool.resize(cap)
            seen.append(pool.high_priority_reserve)
        seen.append(pool.request(16, priority=0))
        pool.release(12)
        return seen

    assert both(scenario)[0] == [1, 4, 2, 4, 12]


# ---------------- one wake/drain hook for capacity increases ----------------

def test_resize_hooks_fire_on_change_only():
    def scenario(alg, core, pkg):
        pool = core.WorkerPool(4)
        fired = []
        hook = lambda old, new: fired.append((old, new))  # noqa: E731
        pool.add_resize_hook(hook)
        for cap in (8, 8, 2):
            pool.resize(cap)
        seen = list(fired)
        pool.remove_resize_hook(hook)
        pool.remove_resize_hook(hook)
        pool.resize(5)
        return seen, fired

    seen, fired = both(scenario)[0]
    assert seen == fired == [(4, 8), (8, 2)]


def test_governor_grow_wakes_parked_run_at_resize_time(graphs):
    rep = _run(graphs, pool=2, sessions=4,
               admission=lambda core: core.AdmissionController(max_inflight=8),
               governor=lambda core: core.CapacityGovernor(p_min=2, p_max=8, window_ns=3e4, cooldown_ns=3e4,
                                                           shrink_util=0.0))
    grows = [(t, old, new) for t, old, new, r in rep.resize_events if r == "grow"]
    assert grows
    first_grow_t = grows[0][0]
    assert any(s == pytest.approx(first_grow_t) for s in sorted(r.started_ns for r in rep.records))


def test_governor_grow_drains_admission_waiters(graphs):
    rep_fixed = _run(graphs, pool=2, sessions=6)
    assert rep_fixed.max_inflight <= 2
    rep = _run(graphs, pool=2, sessions=6,
               governor=lambda core: core.CapacityGovernor(p_min=2, p_max=16, window_ns=3e4, cooldown_ns=3e4,
                                                           shrink_util=0.0))
    assert rep.grow_events > 0
    assert rep.max_inflight > 2


# ---------------- grow under saturation, shrink when idle ----------------

def test_governor_grows_under_sustained_saturation(graphs):
    rep_f = _run(graphs, pool=2, sessions=8)
    rep_g = _run(graphs, pool=2, sessions=8,
                 governor=lambda core: core.CapacityGovernor(p_min=2, p_max=16, window_ns=5e4, cooldown_ns=5e4))
    assert rep_g.grow_events > 0
    caps = [c for _, c in rep_g.capacity_timeline]
    assert max(caps) > 2 and max(caps) <= 16
    assert rep_g.makespan_modeled_ns < rep_f.makespan_modeled_ns
    assert len(rep_g.records) == 8
    assert rep_g.total_edges == pytest.approx(rep_f.total_edges)


def test_governor_shrinks_through_idle_gap(graphs):
    rep = _run(graphs, pool=8, sessions=4, arrivals=[0.0, 1e4, 8e6, 8.01e6],
               governor=lambda core: core.CapacityGovernor(p_min=2, p_max=8, window_ns=5e4, cooldown_ns=1e5,
                                                           shrink_util=0.6))
    assert rep.shrink_events > 0
    assert min(c for _, c in rep.capacity_timeline) == 2
    assert all(2 <= c <= 8 for _, c in rep.capacity_timeline)
    assert len(rep.records) == 4 and all(r.finished_ns > 0 for r in rep.records)


def test_governor_hysteresis_spaces_actions():
    jg = rmat_graph(11, seed=3)
    cooldown = 2e5
    rep = _run({"jax": jg, "torch": port_graph(jg)}, pool=2, sessions=8, queries=2,
               governor=lambda core: core.CapacityGovernor(core.GovernorConfig(p_min=2, p_max=16, window_ns=5e4,
                                                                                 cooldown_ns=cooldown)))
    times = [t for t, *_ in rep.resize_events]
    assert times
    assert all(b - a >= cooldown for a, b in zip(times, times[1:]))


def test_governor_disabled_and_inert_are_bit_identical(graphs):
    rep0 = _run(graphs, pool=4, sessions=6)
    rep1 = _run(graphs, pool=4, sessions=6,
                governor=lambda core: core.CapacityGovernor(p_min=4, p_max=4, window_ns=1e5, cooldown_ns=1e5))
    assert rep1.resize_events == [] and rep1.preemptions == []
    assert [r.traces for r in rep0.records] == [r.traces for r in rep1.records]
    assert rep0.makespan_modeled_ns == pytest.approx(rep1.makespan_modeled_ns)
    assert rep0.total_edges == rep1.total_edges


# ---------------- per-priority admission quotas ----------------

def test_class_quota_blocks_class_not_others():
    def scenario(alg, core, pkg):
        ctrl = core.AdmissionController(class_quotas={0: 2})
        pool = core.WorkerPool(16)
        seen = [ctrl.try_admit(pool, priority=p) for p in (0, 0, 0, 1)] + [ctrl.inflight]
        low, high = SimpleNamespace(priority=0), SimpleNamespace(priority=1)
        ctrl.enqueue(low)
        ctrl.enqueue(high)
        seen += [[w.priority for w in ctrl.drain(pool)], ctrl.waiting_count,
                 [w.priority for w in ctrl.release(pool, priority=0)], dict(ctrl.inflight_by_class)]
        return seen

    assert both(scenario)[0] == [True, True, False, True, 3, [1], 1, [0], {0: 2, 1: 2}]


def test_class_quota_validation_and_reset():
    _raises_alike(ValueError, lambda core: core.AdmissionController(class_quotas={0: 0}))

    def scenario(alg, core, pkg):
        ctrl = core.AdmissionController(class_quotas={0: 1})
        admitted = ctrl.try_admit(core.WorkerPool(4), priority=0)
        ctrl.reset()
        return admitted, ctrl.inflight, dict(ctrl.inflight_by_class)

    assert both(scenario)[0] == (True, 0, {})


def test_engine_honours_class_quotas(graphs):
    counts = {}

    def probe(core):
        class Probe(core.AdmissionController):
            def _admit_one(self, priority):
                super()._admit_one(priority)
                key = core.__name__
                counts[key] = max(counts.get(key, 0), self.inflight_by_class[0])

        return Probe(class_quotas={0: 1})

    rep = _run(graphs, pool=8, sessions=6, admission=probe, priorities=lambda sid: 1 if sid < 2 else 0)
    assert len(rep.records) == 6
    assert counts == {"repro.core": 1, "repro_torch.core": 1}


# ---------------- preemption ----------------

def _hog_and_sprinter(alg, core, graph):
    return lambda s, q: alg.PageRankExecutor(graph, mode="pull", max_iters=6 if s == 0 else 2, tol=0)


def _preempt_run(graphs, preempt):
    return _run(graphs, pool=8, sessions=2, mk=_hog_and_sprinter, priorities=[0, 1], arrivals=[0.0, 5_000.0],
                governor=lambda core: core.CapacityGovernor(p_min=8, p_max=8, window_ns=1e5, cooldown_ns=1e5,
                                                            preempt=preempt))


def test_preemption_frees_workers_for_high_priority(graphs):
    off, on = _preempt_run(graphs, False), _preempt_run(graphs, True)
    assert off.preemptions == []
    assert len(on.preemptions) >= 1
    assert sum(tr.preempted for r in on.records for tr in r.traces) >= 1
    hi_off = [r for r in off.records if r.priority == 1][0]
    hi_on = [r for r in on.records if r.priority == 1][0]
    assert hi_on.latency_ns < hi_off.latency_ns
    assert on.total_edges == pytest.approx(off.total_edges)


def test_preempted_victim_still_completes(graphs):
    rep = _preempt_run(graphs, True)
    victim = [r for r in rep.records if r.priority == 0][0]
    assert victim.finished_ns > 0
    assert victim.edges == pytest.approx(graphs["torch"].num_edges * 6)


def test_preempt_fence_cleared_when_donation_completes_run():
    def scenario(alg, core, pkg):
        pool = core.WorkerPool(8)
        taken = pool.request(7)
        b = core.ThreadBounds(t_min=4, t_max=8, n_packages=8, v_min_parallel=10, parallel=True, cost_seq_ns=1e6,
                              cost_par_ns=2e5)
        pkgs = core.make_packages(np.full(200, 4), b, variance_ratio=1.0)
        srun = core.PackageScheduler(pool, seq_package_limit=4).begin(pkgs, b, stealable=True)
        srun.next_step()
        seen = [srun.preempt(), srun.donate(100).size, srun.done, srun.next_step(), srun.preempt_pending,
                srun.preemptible]
        srun.close()
        seen.append(srun.preempt_pending)
        srun.donation_done()
        pool.release(taken)
        return seen + [pool.available]

    fenced, donated, done, step, pending, preemptible, pending_after, available = both(scenario)[0]
    assert fenced and donated > 0 and done and step is None
    assert not pending and not preemptible and not pending_after
    assert available == 8


# ---------------- stealing under governed capacity ----------------

def test_steal_budget_observes_governed_capacity():
    def scenario(alg, core, pkg):
        budget = core.StealRegistry.steal_budget
        pool = core.WorkerPool(8, high_priority_reserve=2)
        seen = [budget(pool, priority=0), budget(pool, priority=1)]
        taken = pool.request(6, priority=1)
        seen.append(budget(pool, priority=1))
        pool.resize(4)
        seen += [pool.shrink_debt, budget(pool, priority=1)]
        pool.release(taken)
        return seen + [budget(pool, priority=1)]

    assert both(scenario)[0] == [6, 8, 2, 2, 0, 4]


def test_steal_and_governor_compose(graphs):
    def mk(alg, core, g):
        hubs = np.argsort(-np.asarray(g.out_degrees()))
        return lambda s, q: (alg.PageRankExecutor(g, mode="pull", max_iters=6, tol=0) if s == 0
                             else alg.BFSExecutor(g, int(hubs[s % 8])))

    rep = _run(graphs, pool=8, sessions=8, mk=mk, steal=True,
               governor=lambda core: core.CapacityGovernor(p_min=4, p_max=16, window_ns=5e4, cooldown_ns=1e5))
    heavy = [r for r in rep.records if r.algorithm == "pagerank_pull"][0]
    assert heavy.edges == pytest.approx(graphs["torch"].num_edges * 6)
    assert all(r.finished_ns > 0 for r in rep.records)


# ---------------- fig15 acceptance: burst mix wins ----------------

def test_burst_mix_governed_beats_fixed(graphs):
    def mk(alg, core, g):
        hubs = np.argsort(-np.asarray(g.out_degrees()))
        return lambda s, q: (alg.BFSExecutor(g, int(hubs[s % 8])) if s % 3 == 0
                             else alg.PageRankExecutor(g, mode="pull", max_iters=4, tol=0))

    rng = np.random.default_rng(7)
    half = np.cumsum(rng.exponential(1e9 / 30_000.0, size=12))
    arrivals = np.concatenate([half, 2.5e6 + np.cumsum(rng.exponential(1e9 / 30_000.0, size=12))])

    def prio(sid):
        return 1 if sid % 3 == 0 else 0

    fixed = _run(graphs, pool=16, sessions=24, mk=mk, arrivals=arrivals, priorities=prio, steal=True,
                 admission=lambda core: core.AdmissionController())
    governed = _run(graphs, pool=16, sessions=24, mk=mk, arrivals=arrivals, priorities=prio, steal=True,
                    admission=lambda core: core.AdmissionController(class_quotas={0: 12}),
                    governor=lambda core: core.CapacityGovernor(p_min=4, p_max=32, window_ns=1e5, cooldown_ns=1.5e5,
                                                                shrink_util=0.5, grow_step=32, preempt=True))
    assert governed.latency_percentiles_by_priority()[1]["p95"] < fixed.latency_percentiles_by_priority()[1]["p95"]
    assert governed.mean_utilization() > fixed.mean_utilization()
    assert governed.total_edges == pytest.approx(fixed.total_edges)


# ---------------- EngineReport guards ----------------

def _empty_report(core, **kw):
    defaults = dict(records=[], makespan_modeled_ns=0.0, makespan_measured_ns=0.0, pool_capacity=0)
    defaults.update(kw)
    return core.EngineReport(**defaults)


def _rates(rep):
    return [rep.throughput_modeled(), rep.throughput_measured(), rep.steal_rate(), rep.resize_rate(),
            rep.preemption_rate(), rep.mean_utilization(), rep.mean_inflight(), rep.max_inflight,
            rep.mean_capacity(), rep.latency_percentiles(), rep.latency_percentiles_by_session(),
            rep.latency_percentiles_by_priority(), rep.steal_timeline(), rep.total_stolen]


def test_report_rates_guard_empty_and_zero_duration():
    def scenario(alg, core, pkg):
        seen = [_rates(_empty_report(core))]
        rep = _empty_report(core, pool_capacity=4)
        rep.utilization = [(5.0, 2), (5.0, 4)]
        rep.inflight = [(5.0, 1), (5.0, 3)]
        rep.capacity_timeline = [(5.0, 4)]
        seen.append(_rates(rep))
        rep.capacity_timeline = [(5.0, 4), (5.0, 8)]
        return seen + [rep.mean_utilization()]

    empty, instant, elastic = both(scenario)[0]
    assert empty == [0.0] * 9 + [{"p50": 0.0, "p95": 0.0, "p99": 0.0}, {}, {}, [], 0]
    assert 0.0 <= instant[5] <= 1.0 and instant[6] == 2.0 and instant[8] == 4.0
    assert 0.0 <= elastic <= 1.0


def test_report_single_sample_timelines():
    def scenario(alg, core, pkg):
        rep = _empty_report(core, pool_capacity=8)
        rep.utilization = [(0.0, 3)]
        rep.inflight = [(0.0, 2)]
        return rep.mean_utilization(), rep.mean_inflight(), rep.max_inflight

    assert both(scenario)[0] == (0.0, 2.0, 2)
