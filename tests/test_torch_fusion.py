"""The port's gang fusion (``repro_torch.core.fusion`` and the engine's
gangs) against the JAX package's, test for test with
``tests/test_fusion.py``. Each scenario runs in both packages: fused slot
owners, bounds, member traces and modeled times, scan-sharing splits, gang
widths, and whole engine reports (records, fusion, steal and preemption
events, timelines) must be equal, and the reference's assertions hold on
the port."""
import functools
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.graph import rmat_graph  # noqa: E402
from _hypothesis_compat import given, settings, st  # noqa: E402
from _torch_parity import both, packages, plain, port_graph, report_view  # noqa: E402
from _torch_bench_rows import one_torch_thread  # noqa: E402,F401  (autouse: one torch thread a test)


@functools.lru_cache(maxsize=None)
def _graphs12():
    jg = rmat_graph(12, seed=3)
    return {"jax": jg, "torch": port_graph(jg)}


@pytest.fixture(scope="module")
def graphs():
    return _graphs12()


def _bounds(core, t_min=2, t_max=8, n_packages=8):
    return core.ThreadBounds(t_min=t_min, t_max=t_max, n_packages=n_packages, v_min_parallel=10,
                             parallel=True, cost_seq_ns=1e6, cost_par_ns=2e5)


def _member(core, n_packages, t_max=8):
    b = _bounds(core, t_max=t_max, n_packages=n_packages)
    pkgs = core.make_packages(np.full(200, 4), b, variance_ratio=1.0)
    assert pkgs.n_packages == n_packages
    return (SimpleNamespace(name=f"m{n_packages}"), SimpleNamespace(packages=pkgs), b)


def _slot(s):
    return {"complete": s.complete, "modeled_ns": s.modeled_ns, "trace": plain(s.trace),
            "order": plain(s.order), "algorithm": getattr(s, "algorithm", None)}


# ---------------- FusionGroup bookkeeping (unit) ----------------

def test_build_interleaves_members_round_robin():
    def scenario(alg, core, pkg):
        grp = core.FusionGroup.build([_member(core, 2), _member(core, 4)], capacity=16)
        owners = [grp.split(np.array([i]))[0][0] for i in range(6)]
        return (grp.n_packages, [grp.members.index(o) for o in owners], grp.bounds,
                [plain(grp.split(np.array([i]))[0][1:]) for i in range(6)])

    n, idx, b, splits = both(scenario)[0]
    assert n == 6
    assert idx == [0, 1, 0, 1, 1, 1]
    assert b.t_max == 16 and b.n_packages == 6


def test_fused_width_is_capped_sum_of_member_widths():
    def scenario(alg, core, pkg):
        return [core.FusionGroup.build([_member(core, 4, t_max=t), _member(core, 4, t_max=t)], capacity=16).bounds
                for t in (4, 16)]

    small, big = both(scenario)[0]
    assert small.t_max == 8 and big.t_max == 16


def test_split_back_commit_and_early_member_completion():
    def scenario(alg, core, pkg):
        grp = core.FusionGroup.build([_member(core, 2), _member(core, 4)], capacity=16)
        m_short, m_long = grp.members
        for fid in range(4):
            ((slot, positions, local_ids),) = grp.split(np.array([fid]))
            grp.commit_step(slot, positions, local_ids, "parallel", 4, 10.0, 1.0)
        return (_slot(m_short), _slot(m_long), plain(grp.residual(m_long)), plain(grp.residual(m_short)),
                [int(p) for p in m_long.order[2:]])

    short, long_, res_long, res_short, tail = both(scenario)[0]
    assert short["complete"] and not long_["complete"]
    assert short["trace"]["fused_packages"] == 2
    assert short["modeled_ns"] == pytest.approx(20.0)
    assert res_long == tail and res_short == []


def test_donated_positions_wait_for_return_before_completion():
    def scenario(alg, core, pkg):
        grp = core.FusionGroup.build([_member(core, 2), _member(core, 2)], capacity=16)
        slot = grp.members[0]
        positions = np.array([0, 1])
        grp.mark_donated(slot, positions, slot.order[positions], workers=2)
        seen = [slot.trace.stolen_packages, grp.residual(slot).size, slot.complete]
        grp.account_stolen(slot, 5.0, 1.0)
        return seen + [slot.complete, slot.modeled_ns, _slot(slot)]

    stolen, residual, done_before, done_after, modeled, _ = both(scenario)[0]
    assert stolen == 2 and residual == 0 and not done_before
    assert done_after and modeled == pytest.approx(5.0)


def test_should_fuse_requires_contention():
    def scenario(alg, core, pkg):
        from_core = __import__(core.__name__ + ".fusion", fromlist=["should_fuse"]).should_fuse
        a, b = _member(core, 4, t_max=8), _member(core, 4, t_max=8)
        return [from_core([a], capacity=4), from_core([a, b], capacity=8), from_core([a, b], capacity=16)]

    assert both(scenario)[0] == [False, True, False]


def test_fusion_config_validation():
    for kw in (dict(hold_ns=-1.0), dict(max_members=1)):
        msgs = []
        for _, core in packages().values():
            with pytest.raises(ValueError) as err:
                core.FusionConfig(**kw)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]


# ---------------- engine integration ----------------

def _mk_pr(alg, graph, max_iters=3):
    return lambda s, q: alg.PageRankExecutor(graph, mode="pull", max_iters=max_iters, tol=0)


def _run(graphs, *, sessions=4, pool=8, fuse=False, steal=False, max_iters=3, governor=None, priorities=None,
         arrivals=None, mk=None, fusion=None, queries=1, hetero=False):
    """The run in both engines, reports equal; returns the port's. ``mk``
    and ``governor`` are ``(alg, core, graph) -> ...`` factories; ``fusion``
    the kwargs of a ``FusionConfig``."""

    def scenario(alg, core, pkg):
        g = graphs[pkg]
        eng = core.MultiQueryEngine(core.XEON_E5_2660V4, pool_capacity=pool, policy="scheduler")
        rep = eng.run_sessions(
            mk(alg, core, g) if mk else _mk_pr(alg, g, max_iters=max_iters), sessions=sessions,
            queries_per_session=queries,
            config=core.EngineConfig(steal=steal, fuse=fuse,
                                     fusion=core.FusionConfig(**fusion) if fusion is not None else None,
                                     governor=governor(core) if governor else None, priorities=priorities,
                                     arrivals=arrivals, hetero_fuse=hetero))
        assert eng.pool.available == eng.pool.capacity, "grant leaked"
        return rep

    return both(scenario, report_view)[0]


def test_gang_forms_and_split_back_conserves_work(graphs):
    unfused = _run(graphs, fuse=False)
    fused = _run(graphs, fuse=True)
    assert fused.fusion_events
    assert fused.total_fused > 0
    assert fused.total_fused == sum(r.fused_packages for r in fused.records)
    for ru, rf in zip(unfused.records, fused.records):
        assert rf.edges == ru.edges
        assert rf.iterations == ru.iterations
        assert [len(tr.runs) for tr in rf.traces] == [len(tr.runs) for tr in ru.traces]
        assert rf.fused_packages > 0
        assert rf.finished_ns > 0


def test_fused_burst_beats_unfused_modeled_throughput(graphs):
    unfused = _run(graphs, fuse=False)
    fused = _run(graphs, fuse=True)
    assert fused.throughput_modeled() > unfused.throughput_modeled() * 1.05


def test_fuse_false_is_inert_and_deterministic(graphs):
    a = _run(graphs, fuse=False)
    b = _run(graphs, fuse=False)
    assert not a.fusion_events and a.total_fused == 0
    assert all(r.fused_packages == 0 for r in a.records)
    assert [r.modeled_ns for r in a.records] == [r.modeled_ns for r in b.records]
    assert a.makespan_modeled_ns == b.makespan_modeled_ns


def test_fusion_groups_across_distinct_graph_objects():
    from repro_torch.graph import rmat_graph as port_rmat_graph

    copies = {"jax": [rmat_graph(12, seed=3) for _ in range(4)],
              "torch": [port_rmat_graph(12, seed=3, device="cpu") for _ in range(4)]}
    for cs in copies.values():
        assert cs[0] is not cs[1] and cs[0].key == cs[1].key
    assert copies["torch"][0].key == copies["jax"][0].key

    def scenario(alg, core, pkg):
        cs = copies[pkg]
        eng = core.MultiQueryEngine(core.XEON_E5_2660V4, pool_capacity=8, policy="scheduler")
        return eng.run_sessions(lambda s, q: alg.PageRankExecutor(cs[s], mode="pull", max_iters=3, tol=0),
                                sessions=4, queries_per_session=1, config=core.EngineConfig(fuse=True))

    rep = both(scenario, report_view)[0]
    assert rep.fusion_events
    assert all(r.finished_ns > 0 and r.edges > 0 for r in rep.records)


def test_uncontended_pool_does_not_fuse(graphs):
    rep = _run(graphs, sessions=2, pool=56, fuse=True)
    assert not rep.fusion_events and rep.total_fused == 0


def _hubs(g):
    return np.argsort(-np.asarray(g.out_degrees()))


def test_bfs_sessions_fuse_and_conserve_edges(graphs):
    def mk_bfs(alg, core, g):
        hubs = _hubs(g)
        return lambda s, q: alg.BFSExecutor(g, int(hubs[s]))

    solo_edges = []
    for s in range(4):
        def mk_one(alg, core, g, s=s):
            return lambda _s, _q: mk_bfs(alg, core, g)(s, 0)

        solo_edges.append(_run(graphs, sessions=1, pool=8, mk=mk_one).records[0].edges)
    rep = _run(graphs, sessions=4, pool=8, fuse=True, mk=mk_bfs, fusion=dict(hold_ns=1e6))
    assert rep.fusion_events
    for r, expected in zip(rep.records, solo_edges):
        assert r.edges == expected


def _gov(core):
    return core.CapacityGovernor(p_min=8, p_max=8, window_ns=1e5, cooldown_ns=1e12, preempt=True)


def test_defuse_on_preemption(graphs):
    def mk(alg, core, g):
        return _mk_pr(alg, g, max_iters=4)

    unfused = _run(graphs, sessions=5, pool=8, mk=mk)
    rep = _run(graphs, sessions=5, pool=8, fuse=True, mk=mk, governor=_gov, priorities=[0, 0, 0, 0, 1],
               arrivals=[0.0, 0.0, 0.0, 0.0, 2e5])
    assert rep.fusion_events
    assert rep.preemptions
    assert [tr for r in rep.records for tr in r.traces if tr.preempted > 0]
    for ru, rf in zip(unfused.records, rep.records):
        assert rf.edges == ru.edges
        assert rf.iterations == ru.iterations


def test_stealing_from_fused_gang_conserves_work(graphs):
    def mk(alg, core, g):
        hub = int(_hubs(g)[0])

        def make(s, q):
            if s == 3:
                return alg.BFSExecutor(g, hub)
            return alg.PageRankExecutor(g, mode="pull", max_iters=4, tol=0)

        return make

    unfused = _run(graphs, sessions=4, pool=5, mk=mk, steal=False)
    rep = _run(graphs, sessions=4, pool=5, mk=mk, steal=True, fuse=True)
    assert rep.fusion_events
    for ru, rf in zip(unfused.records, rep.records):
        assert rf.edges == ru.edges
    fused_victim_steals = [e for e in rep.steal_events if e[2] < 0]
    assert fused_victim_steals
    assert sum(k for *_, k in fused_victim_steals) <= sum(r.stolen_packages for r in rep.records)
    assert all(r.session >= 0 for r in rep.records)


# ---------------- heterogeneous scan-sharing fusion ----------------

def test_scan_sharing_conserves_totals_exactly():
    shares, scans = [100.0, 200.0, 300.0], [50.0, 80.0, 20.0]
    adjusted, _ = both(lambda alg, core, pkg: core.apply_scan_sharing(shares, scans))
    savings = sum(scans) - max(scans)
    assert sum(adjusted) == pytest.approx(sum(shares) - savings)
    for adj, share, scan in zip(adjusted, shares, scans):
        assert adj == pytest.approx(share - savings * scan / sum(scans))
        assert share - scan <= adj <= share


def test_scan_sharing_noop_cases():
    cases = [([100.0], [40.0]), ([1.0, 2.0], [0.0, 0.0]), ([1.0, 2.0], [0.0, 5.0])]
    got, _ = both(lambda alg, core, pkg: [core.apply_scan_sharing(s, c) for s, c in cases])
    assert got == [[100.0], [1.0, 2.0], [1.0, 2.0]]


@settings(deadline=None, max_examples=50)
@given(n=st.integers(1, 8), seed=st.integers(0, 10_000))
def test_scan_sharing_conservation_property(n, seed):
    rng = np.random.default_rng(seed)
    shares = [float(s) for s in 10.0 ** rng.uniform(0, 9, size=n)]
    scans = [s * float(f) for s, f in zip(shares, rng.uniform(0, 1, size=n))]
    adjusted, _ = both(lambda alg, core, pkg: core.apply_scan_sharing(shares, scans))
    savings = max(sum(scans) - max(scans), 0.0) if n > 1 else 0.0
    assert sum(adjusted) == pytest.approx(sum(shares) - savings, rel=1e-9)
    for adj, share, scan in zip(adjusted, shares, scans):
        assert adj <= share + 1e-9 * share
        assert adj >= share - scan - 1e-9 * share


def _work(core, frontier, edges, m_bytes=None):
    return core.IterationWork(frontier=float(frontier), edges=float(edges), found=float(frontier),
                              touched=float(frontier),
                              m_bytes=float(m_bytes if m_bytes is not None else frontier * 8))


def test_member_scan_ns_is_the_plain_memory_edge_slice():
    def scenario(alg, core, pkg):
        hw, w = core.XEON_E5_2660V4, _work(core, 8192, 131072)
        return [core.DEGREE_COUNT.e.n_mem, core.member_scan_ns(core.DEGREE_COUNT, hw, w, 8, 1.0),
                core.member_scan_ns(core.PR_PULL, hw, w, 1, 1.0), core.member_scan_ns(core.PR_PULL, hw, w, 8, 1.0),
                core.member_scan_ns(core.PR_PULL, hw, w, 8, 0.25)]

    n_mem, dc, s1, s8, s8q = both(scenario)[0]
    assert n_mem == 0 and dc == 0.0
    assert s1 > 0 and s8 == pytest.approx(s1 / 8)
    assert s8q == pytest.approx(s8 / 4)


def test_hetero_group_tags_and_member_groups():
    def scenario(alg, core, pkg):
        staged = [_member(core, 2), _member(core, 3), _member(core, 2)]
        grp = core.FusionGroup.build(staged, capacity=16, algorithms=["pr", "bfs", "pr"], scan_shared=True)
        groups = grp.member_groups()
        owners = [grp.split(np.array([fid]))[0][0].algorithm for fid in range(grp.n_packages)]
        return (grp.scan_shared, grp.heterogeneous, grp.algorithms,
                {k: [next(i for i, x in enumerate(grp.members) if x is m) for m in v] for k, v in groups.items()},
                None if grp.packages.tags is None else [str(t) for t in grp.packages.tags], owners, grp.n_packages)

    shared, het, algos, groups, tags, owners, n = both(scenario)[0]
    assert shared and het
    assert algos == ["pr", "bfs"]
    assert len(groups["pr"]) == 2 and len(groups["bfs"]) == 1
    assert tags is not None and len(tags) == n
    assert tags == owners


def test_homogeneous_group_has_no_tags():
    def scenario(alg, core, pkg):
        grp = core.FusionGroup.build([_member(core, 2), _member(core, 4)], capacity=16)
        return grp.packages.tags, grp.heterogeneous, grp.algorithms, grp.scan_shared

    assert both(scenario)[0] == (None, False, [], False)


def _staged(core, *works):
    return [(None, SimpleNamespace(work=_work(core, *w)), _bounds(core, t_max=16)) for w in works]


def test_plan_hetero_width_single_algorithm_delegates():
    def scenario(alg, core, pkg):
        staged, hw = _staged(core, (4096, 65536), (4096, 65536)), core.XEON_E5_2660V4
        return (core.plan_hetero_gang_width(staged, [core.PR_PULL, core.PR_PULL], hw, capacity=16),
                core.plan_gang_width(staged, core.PR_PULL, hw, capacity=16))

    het, homo = both(scenario)[0]
    assert het == homo


def test_plan_hetero_width_mixed_is_pow2_within_cap():
    def scenario(alg, core, pkg):
        return core.plan_hetero_gang_width(_staged(core, (8192, 131072), (100, 200)),
                                           [core.PR_PULL, core.DEGREE_COUNT], core.XEON_E5_2660V4, capacity=16)

    assert both(scenario)[0] in (2, 4, 8, 16)


def test_plan_hetero_width_censored_falls_back_most_conservative():
    def scenario(alg, core, pkg):
        hw = core.XEON_E5_2660V4
        staged, descs = _staged(core, (8192, 131072), (20, 40)), [core.PR_PULL, core.DEGREE_COUNT]
        cold = core.plan_hetero_gang_width(staged, descs, hw, capacity=16)
        fb = core.CostFeedback()
        fb.observe(core.DEGREE_COUNT.name, "parallel", modeled_ns=1.0, measured_ns=2.0)
        for w in (2, 4, 8, 16):
            fb.observe(core.DEGREE_COUNT.name, "parallel", width=w, modeled_ns=1.0, measured_ns=1e6)
        return cold, fb.width_censored(core.DEGREE_COUNT.name, 2), core.plan_hetero_gang_width(
            staged, descs, hw, capacity=16, feedback=fb)

    cold, censored, warm = both(scenario)[0]
    assert cold >= 4
    assert censored
    assert warm == 2


def _mixed_burst_mk(alg, core, g):
    hub = int(_hubs(g)[0])

    def mk(s, q):
        if s == 2:
            return alg.DegreeCountExecutor(g)
        if s == 3:
            return alg.BFSExecutor(g, hub)
        return alg.PageRankExecutor(g, mode="pull", max_iters=3, tol=0)

    return mk


def test_hetero_burst_fuses_across_algorithms_and_conserves_work(graphs):
    unfused = _run(graphs, mk=_mixed_burst_mk, fuse=False)
    homo = _run(graphs, mk=_mixed_burst_mk, fuse=True, fusion=dict(hold_ns=2e4))
    het = _run(graphs, mk=_mixed_burst_mk, fuse=True, hetero=True, fusion=dict(hold_ns=2e4))
    assert het.fusion_events
    for ru, rh in zip(unfused.records, het.records):
        assert rh.edges == ru.edges
        assert rh.iterations == ru.iterations
        assert [len(tr.runs) for tr in rh.traces] == [len(tr.runs) for tr in ru.traces]
    bfs_homo = [r for r in homo.records if r.algorithm == "bfs_top_down"][0]
    bfs_het = [r for r in het.records if r.algorithm == "bfs_top_down"][0]
    assert bfs_homo.fused_packages == 0
    assert bfs_het.fused_packages > 0


def test_hetero_fuse_implies_fuse(graphs):
    rep = _run(graphs, mk=_mixed_burst_mk, fuse=False, hetero=True, fusion=dict(hold_ns=2e4))
    assert rep.fusion_events


def test_hetero_defuse_on_preemption_resumes_own_algorithm(graphs):
    def mk(alg, core, g):
        base = _mixed_burst_mk(alg, core, g)

        def make(s, q):
            if s == 4:
                return alg.PageRankExecutor(g, mode="pull", max_iters=3, tol=0)
            return base(s, q)

        return make

    unfused = _run(graphs, sessions=5, pool=8, mk=mk)
    rep = _run(graphs, sessions=5, pool=8, fuse=True, hetero=True, mk=mk, governor=_gov, fusion=dict(hold_ns=2e4),
               priorities=[0, 0, 0, 0, 1], arrivals=[0.0, 0.0, 0.0, 0.0, 2e5])
    assert rep.fusion_events
    assert rep.preemptions
    assert any(tr.preempted > 0 for r in rep.records for tr in r.traces)
    for ru, rf in zip(unfused.records, rep.records):
        assert rf.edges == ru.edges
        assert rf.iterations == ru.iterations


@settings(deadline=None, max_examples=8)
@given(sessions=st.integers(2, 5), pool=st.integers(4, 8))
def test_fused_grants_never_oversubscribe_pool(sessions, pool):
    graphs = _graphs12()

    def mk(alg, core, g):
        return _mk_pr(alg, g, max_iters=1)

    rep = _run(graphs, sessions=sessions, pool=pool, fuse=True, mk=mk)
    assert max((u for _, u in rep.utilization), default=0) <= pool
    assert all(r.finished_ns > 0 for r in rep.records)
