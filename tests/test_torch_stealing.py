"""The port's inter-session work-stealing (``StealRegistry``, the victim
fence on ``ScheduleRun``, the engine's steals) against the JAX package's,
test for test with ``tests/test_stealing.py``. Each scenario runs in both
packages: victim picks, donated package ids, ``ScheduleRun`` steps and
traces, gang widths, and whole engine reports (records, steal and fusion
events, timelines) must be equal, and the reference's assertions hold on
the port."""
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.graph import rmat_graph  # noqa: E402
from repro_torch.graph import rmat_graph as port_rmat_graph  # noqa: E402
from _torch_parity import both, plain, port_graph, report_view  # noqa: E402
from _torch_bench_rows import one_torch_thread  # noqa: E402,F401  (autouse: one torch thread a test)


@pytest.fixture(scope="module")
def graphs(medium_rmat):
    return {"jax": medium_rmat, "torch": port_graph(medium_rmat)}


def _bounds(core, t_min=4, t_max=8, n_packages=8):
    return core.ThreadBounds(t_min=t_min, t_max=t_max, n_packages=n_packages, v_min_parallel=10,
                             parallel=True, cost_seq_ns=1e6, cost_par_ns=2e5)


def _fake_run(backlog, grinding=True):
    return SimpleNamespace(stealable_backlog=backlog, grinding=grinding)


def _key(entry):
    return None if entry is None else entry.key


# ---------------- StealRegistry ----------------

def test_registry_publish_pick_withdraw():
    def scenario(alg, core, pkg):
        reg = core.StealRegistry()
        seen = [_key(reg.pick_victim())]
        reg.publish(0, _fake_run(5), priority=0, graph_key="g1")
        reg.publish(1, _fake_run(9), priority=0, graph_key="g2")
        seen += [len(reg), reg.total_backlog(), _key(reg.pick_victim()), _key(reg.pick_victim(thief_key=1))]
        reg.withdraw(1)
        seen.append(_key(reg.pick_victim()))
        reg.withdraw(0)
        seen.append(_key(reg.pick_victim()))
        reg.withdraw(42)
        return seen

    got, _ = both(scenario)
    assert got == [None, 2, 14, 1, 0, 0, None]


def test_registry_ignores_empty_backlogs():
    def scenario(alg, core, pkg):
        reg = core.StealRegistry()
        reg.publish(0, _fake_run(0))
        seen = [_key(reg.pick_victim())]
        reg.publish(1, _fake_run(2))
        return seen + [_key(reg.pick_victim(min_backlog=3)), _key(reg.pick_victim(min_backlog=2))]

    assert both(scenario)[0] == [None, None, 1]


def test_registry_prefers_same_graph_victims():
    def scenario(alg, core, pkg):
        reg = core.StealRegistry()
        reg.publish(0, _fake_run(50), graph_key="other")
        reg.publish(1, _fake_run(3), graph_key="mine")
        return [_key(reg.pick_victim(graph_key="mine")), _key(reg.pick_victim())]

    assert both(scenario)[0] == [1, 0]


def test_registry_prefers_high_priority_victims():
    def scenario(alg, core, pkg):
        reg = core.StealRegistry()
        reg.publish(0, _fake_run(50), priority=0)
        reg.publish(1, _fake_run(3), priority=1)
        seen = [_key(reg.pick_victim())]
        reg.publish(2, _fake_run(2), priority=0, graph_key="mine")
        return seen + [_key(reg.pick_victim(graph_key="mine"))]

    assert both(scenario)[0] == [1, 2]


# ---------------- victim fence on ScheduleRun ----------------

def _grinding_run(core, stealable=True, tags=None):
    pool = core.WorkerPool(8)
    taken = pool.request(7)  # 1 worker left: a sequential grind
    b = _bounds(core)
    pkgs = core.make_packages(np.full(200, 4), b, variance_ratio=1.0)
    kw = {} if tags is None else {"tags": tags}
    srun = core.PackageScheduler(pool, seq_package_limit=4).begin(pkgs, b, stealable=stealable, **kw)
    return pool, taken, pkgs, srun


def _step(s):
    return None if s is None else (s.mode, [int(p) for p in s.batch], s.workers)


def test_donate_claims_tail_and_fences_victim():
    def scenario(alg, core, pkg):
        pool, taken, pkgs, srun = _grinding_run(core)
        first = srun.next_step()
        seen = {"first": _step(first), "grinding": srun.grinding, "backlog": srun.stealable_backlog}
        stolen = srun.donate(3, workers=2)
        seen.update(stolen=[int(p) for p in stolen], out=srun.outstanding_donations,
                    traced=srun.trace.stolen_packages, order=[int(p) for p in pkgs.order[: pkgs.n_packages]])
        steps = []
        while (s := srun.next_step()) is not None:
            steps.append(_step(s))
        srun.donation_done()
        seen.update(steps=steps, out_after=srun.outstanding_donations, n=pkgs.n_packages)
        srun.close()
        pool.release(taken)
        seen.update(available=pool.available, trace=srun.trace)
        return seen

    got, _ = both(scenario)
    assert got["first"][0] == "sequential" and got["grinding"]
    assert got["backlog"] == got["n"] - 1
    assert len(got["stolen"]) == 3 and got["out"] == 1 and got["traced"] == 3
    assert got["stolen"] == got["order"][-3:]
    handed = got["first"][1] + [p for s in got["steps"] for p in s[1]]
    assert all(s[0] != "stalled" for s in got["steps"])
    assert set(handed).isdisjoint(got["stolen"])
    assert len(handed) + 3 == got["n"]
    assert got["out_after"] == 0 and got["available"] == 8


def test_donate_never_exceeds_backlog():
    def scenario(alg, core, pkg):
        pool, taken, pkgs, srun = _grinding_run(core)
        srun.next_step()
        stolen = srun.donate(100)
        seen = (stolen.size, srun.trace.stolen_packages, pkgs.n_packages, srun.stealable_backlog,
                srun.donate(1).size)
        srun.close()
        pool.release(taken)
        return seen

    size, traced, n, backlog, again = both(scenario)[0]
    assert size == traced <= n - 1
    assert backlog == 0 and again == 0


def test_grinding_resets_on_parallel_recovery():
    def scenario(alg, core, pkg):
        pool, taken, _, srun = _grinding_run(core)
        seen = [_step(srun.next_step()), srun.grinding]
        pool.release(taken)
        seen += [_step(srun.next_step()), srun.grinding]
        srun.close()
        return seen

    first, grinding, step, after = both(scenario)[0]
    assert first[0] == "sequential" and grinding
    assert step[0] == "parallel" and not after


def test_donations_outlive_close():
    def scenario(alg, core, pkg):
        pool, taken, _, srun = _grinding_run(core)
        srun.next_step()
        seen = [srun.donate(3).size]
        srun.close()
        seen += [srun.outstanding_donations, srun.stealable_backlog, srun.donate(1).size]
        srun.donation_done()
        seen.append(srun.outstanding_donations)
        pool.release(taken)
        return seen + [pool.available]

    assert both(scenario)[0] == [3, 1, 0, 0, 0, 8]


def test_non_stealable_run_publishes_nothing():
    def scenario(alg, core, pkg):
        pool, taken, _, srun = _grinding_run(core, stealable=False)
        srun.next_step()
        seen = [srun.grinding, srun.stealable_backlog, srun.donate(3).size]
        srun.close()
        pool.release(taken)
        return seen

    assert both(scenario)[0] == [True, 0, 0]


def test_width_capped_parallel_run_is_stealable():
    def scenario(alg, core, pkg):
        pool = core.WorkerPool(16)
        b = _bounds(core, t_min=2, t_max=8, n_packages=16)
        pkgs = core.make_packages(np.full(400, 4), b, variance_ratio=1.0)
        srun = core.PackageScheduler(pool).begin(pkgs, b, stealable=True)
        seen = [srun.width_capped, srun.stealable_backlog, pkgs.n_packages]
        step = srun.next_step()
        seen += [_step(step), srun.stealable_backlog]
        srun.close()
        taken = pool.request(12)
        srun = core.PackageScheduler(pool).begin(pkgs, b, stealable=True)
        seen += [srun.width_capped, srun.stealable_backlog]
        srun.close()
        pool.release(taken)
        return seen + [pool.available]

    capped, backlog, n, step, tail, capped2, backlog2, available = both(scenario)[0]
    assert capped and backlog == n
    assert step[0] == "parallel" and len(step[1]) == step[2] == 8
    assert tail == n - 8
    assert not capped2 and backlog2 == 0 and available == 16


# ---------------- heterogeneous victims: tagged tails, mixed thief gangs ----------------

def test_tail_tags_reports_trailing_algorithms():
    def scenario(alg, core, pkg):
        pool = core.WorkerPool(8)
        taken = pool.request(7)
        b = _bounds(core)
        pkgs = core.make_packages(np.full(200, 4), b, variance_ratio=1.0)
        tags = np.asarray(["pr" if i % 2 == 0 else "bfs" for i in range(pkgs.n_packages)])
        srun = core.PackageScheduler(pool, seq_package_limit=4).begin(pkgs, b, stealable=True, tags=tags)
        srun.next_step()
        backlog = srun.stealable_backlog
        order = [int(p) for p in pkgs.order[: pkgs.n_packages]]
        seen = [backlog, sorted(srun.tail_tags(backlog)), srun.tail_tags(1), str(tags[order[-1]]),
                srun.tail_tags(0), srun.tail_tags(backlog // 2)]
        srun.close()
        untagged = core.PackageScheduler(pool, seq_package_limit=4).begin(pkgs, b, stealable=True)
        untagged.next_step()
        seen.append(untagged.tail_tags(5))
        untagged.close()
        pool.release(taken)
        return seen

    backlog, all_tags, one, last, none, half, untagged = both(scenario)[0]
    assert backlog > 2
    assert all_tags == ["bfs", "pr"]
    assert one == [last] and none == [] and untagged == []


def _seeded_mixed_fb(core):
    fb = core.CostFeedback()
    fb.observe("a", "parallel", modeled_ns=1.0, measured_ns=1.0)
    fb.observe("b", "parallel", modeled_ns=1.0, measured_ns=1.0)
    for w in (2, 4, 8, 16):
        fb.observe("a", "parallel", width=w, modeled_ns=1.0, measured_ns=1.0)
        for _ in range(20):
            fb.observe("b", "parallel", width=w, modeled_ns=1.0, measured_ns=1.0 if w <= 4 else 7.9)
    return fb


def test_thief_gang_width_mixed_blends_member_ratios():
    def scenario(alg, core, pkg):
        fb, reg = _seeded_mixed_fb(core), core.StealRegistry
        return [reg.thief_gang_width(fb, "a", 16, 16), reg.thief_gang_width(fb, "b", 16, 16),
                reg.thief_gang_width_mixed(fb, ["a", "b"], 16, 16), reg.thief_gang_width_mixed(fb, ["b"], 16, 16),
                reg.thief_gang_width_mixed(fb, [], 16, 16), reg.thief_gang_width_mixed(fb, ["a", "b"], 16, 0),
                [reg.thief_gang_width_mixed(fb, ["a", "b"], 16, k) for k in range(1, 17)],
                [reg.thief_gang_width(fb, "b", t, 16) for t in (1, 2, 4, 8, 16)]]

    wide, narrow, mixed, b_only, empty, zero, *_ = both(scenario)[0]
    assert wide == 16
    assert narrow <= 4
    assert narrow <= mixed < 16
    assert b_only == narrow and empty == 16 and zero == 0


def test_publish_carries_member_algorithms():
    def scenario(alg, core, pkg):
        reg = core.StealRegistry()
        entry = reg.publish(0, _fake_run(5), fused=True, algorithms=("pr_pull", "bfs"))
        return [entry.algorithms, reg.publish(1, _fake_run(5)).algorithms]

    assert both(scenario)[0] == [("pr_pull", "bfs"), ()]


def test_stolen_hetero_tail_runs_correct_compute_body(graphs):
    def run(alg, core, pkg, steal, hetero):
        g = graphs[pkg]
        hub = int(np.argsort(-np.asarray(g.out_degrees()))[0])

        def mk(s, q):
            if s == 2:
                return alg.DegreeCountExecutor(g)
            if s == 3:
                return alg.BFSExecutor(g, hub)
            return alg.PageRankExecutor(g, mode="pull", max_iters=4, tol=0)

        eng = core.MultiQueryEngine(core.XEON_E5_2660V4, pool_capacity=5, policy="scheduler")
        rep = eng.run_sessions(mk, sessions=4, queries_per_session=1, config=core.EngineConfig(
            steal=steal, fuse=hetero, hetero_fuse=hetero,
            fusion=core.FusionConfig(hold_ns=2e4) if hetero else None))
        assert eng.pool.available == eng.pool.capacity
        return rep

    unfused, _ = both(lambda *a: run(*a, steal=False, hetero=False), report_view)
    rep, _ = both(lambda *a: run(*a, steal=True, hetero=True), report_view)
    assert rep.fusion_events
    for ru, rf in zip(unfused.records, rep.records):
        assert rf.edges == ru.edges
        assert rf.iterations == ru.iterations
    fused_victim_steals = [e for e in rep.steal_events if e[2] < 0]
    assert fused_victim_steals
    assert sum(k for *_, k in fused_victim_steals) <= sum(r.stolen_packages for r in rep.records)
    assert all(r.session >= 0 for r in rep.records)


# ---------------- engine integration ----------------

def _skew_mk(alg, graph):
    hubs = np.argsort(-np.asarray(graph.out_degrees()))

    def mk(s, q):
        if s == 0:
            return alg.PageRankExecutor(graph, mode="pull", max_iters=6, tol=0)
        return alg.BFSExecutor(graph, int(hubs[s % 8]))

    return mk


def _skewed(graphs, steal):
    def scenario(alg, core, pkg):
        eng = core.MultiQueryEngine(core.XEON_E5_2660V4, pool_capacity=16, policy="scheduler")
        rep = eng.run_sessions(_skew_mk(alg, graphs[pkg]), sessions=8, queries_per_session=1,
                               config=core.EngineConfig(steal=steal))
        assert eng.pool.available == eng.pool.capacity
        return rep

    return both(scenario, report_view)[0]


def test_skewed_mix_steal_beats_nosteal(graphs):
    off, on = _skewed(graphs, False), _skewed(graphs, True)
    assert off.total_stolen == 0
    assert on.total_stolen > 0
    assert on.throughput_modeled() > off.throughput_modeled()
    assert on.mean_utilization() > off.mean_utilization()
    heavy = [r for r in on.records if r.algorithm == "pagerank_pull"][0]
    assert heavy.stolen_packages > 0
    assert sum(r.stolen_packages for r in on.records) == on.total_stolen


def test_stolen_work_is_exactly_once(graphs):
    rep = _skewed(graphs, True)
    heavy = [r for r in rep.records if r.algorithm == "pagerank_pull"][0]
    assert heavy.iterations == 6
    assert heavy.edges == pytest.approx(graphs["torch"].num_edges * 6)
    stolen_runs = [run for tr in heavy.traces for run in tr.runs if run.mode == "stolen"]
    assert len(stolen_runs) == heavy.stolen_packages
    assert sum(tr.stolen_packages for tr in heavy.traces) == heavy.stolen_packages


def test_uniform_load_steal_is_neutral(graphs):
    thr = {}
    for steal in (False, True):
        def scenario(alg, core, pkg):
            g = graphs[pkg]
            eng = core.MultiQueryEngine(core.XEON_E5_2660V4, policy="scheduler")
            return eng.run_sessions(lambda s, q: alg.PageRankExecutor(g, mode="pull", max_iters=3, tol=0),
                                    sessions=16, queries_per_session=1, config=core.EngineConfig(steal=steal))

        thr[steal] = both(scenario, report_view)[0].throughput_modeled()
    assert thr[True] == pytest.approx(thr[False], rel=0.02)


def test_single_session_steal_traces_match_run_query(graphs):
    def scenario(alg, core, pkg):
        g = graphs[pkg]
        rec = core.QueryRecord(0, 0, "pr")
        core.MultiQueryEngine(core.XEON_E5_2660V4, policy="scheduler").run_query(
            alg.PageRankExecutor(g, mode="pull", max_iters=5, tol=0), rec)
        rep = core.MultiQueryEngine(core.XEON_E5_2660V4, policy="scheduler").run_sessions(
            lambda s, q: alg.PageRankExecutor(g, mode="pull", max_iters=5, tol=0), sessions=1,
            queries_per_session=1, config=core.EngineConfig(steal=True))
        return rec, rep

    (rec, rep), _ = both(scenario, lambda out: (plain(out[0]), report_view(out[1])))
    r = rep.records[0]
    assert rep.total_stolen == 0
    assert rec.traces == r.traces
    assert rec.modeled_ns == pytest.approx(r.modeled_ns)
    assert rec.edges == r.edges


def test_steal_report_fields(graphs):
    rep = _skewed(graphs, True)
    assert rep.steal_events
    ts = [t for t, *_ in rep.steal_events]
    assert ts == sorted(ts)
    timeline = rep.steal_timeline()
    assert timeline[-1][1] == rep.total_stolen
    assert [c for _, c in timeline] == sorted(c for _, c in timeline)
    assert rep.steal_rate() > 0
    for t, thief, victim, k in rep.steal_events:
        assert thief != victim and k >= 1


# ---------------- stable graph identity (steal/fusion grouping) ----------------

def _port_rmat(scale, seed):
    return port_rmat_graph(scale, seed=seed, device="cpu")


def test_graph_key_stable_across_loads():
    a, b = _port_rmat(10, 5), _port_rmat(10, 5)
    assert a is not b
    assert a.key == b.key == rmat_graph(10, seed=5).key
    assert a.key != _port_rmat(10, 6).key
    assert a.key != _port_rmat(11, 5).key


def test_graph_identity_prefers_key_over_object_identity():
    from repro_torch.core import graph_identity

    g1, g2 = _port_rmat(10, 5), _port_rmat(10, 5)
    assert graph_identity(SimpleNamespace(graph=g1)) == graph_identity(SimpleNamespace(graph=g2))
    bare = SimpleNamespace()
    ex1, ex2 = SimpleNamespace(graph=bare), SimpleNamespace(graph=bare)
    assert graph_identity(ex1) == graph_identity(ex2) == id(bare)
    assert graph_identity(SimpleNamespace()) is None


def test_same_dataset_distinct_objects_rank_as_same_graph():
    from repro_torch.core import StealRegistry

    g1, g2 = _port_rmat(10, 5), _port_rmat(10, 5)
    other = _port_rmat(10, 6)
    reg = StealRegistry()
    reg.publish(0, _fake_run(50), graph_key=other.key)
    reg.publish(1, _fake_run(3), graph_key=g1.key)
    assert reg.pick_victim(graph_key=g2.key).key == 1
