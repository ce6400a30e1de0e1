"""The port's locality domains end to end against the JAX package's, test
for test with ``tests/test_locality.py``: the same burst on the same
clustered graph through both engines gives equal records (modeled times
and decision traces), makespans, per-domain utilization timelines and
cross-domain steal counts, and the reference's orderings hold on the
port."""
import pytest

pytest.importorskip("torch")

import repro.algorithms as jalg  # noqa: E402
import repro.core as jcore  # noqa: E402
import repro_torch.algorithms as talg  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro.graph import clustered_graph  # noqa: E402
from _torch_parity import plain, port_graph, records, report_numbers  # noqa: E402
from _torch_bench_rows import one_torch_thread  # noqa: E402,F401  (autouse: one torch thread a test)

BLOCK = 1 << 10
PKGS = {"jax": (jalg, jcore), "torch": (talg, tcore)}


@pytest.fixture(scope="module")
def clustered():
    jg = clustered_graph(10, 4, seed=3, cross_fraction=0.0)
    return {"jax": jg, "torch": port_graph(jg)}


def _mk_burst(alg, graph):
    def make(sid, q):
        if sid % 4 == 3:
            return alg.PageRankExecutor(graph, mode="pull", max_iters=2, tol=0)
        return alg.BFSExecutor(graph, source=((sid + 1) % 4) * BLOCK + (sid * 131 + q * 17) % BLOCK)

    return make


def _engine(pkg):
    return PKGS[pkg][1].MultiQueryEngine(PKGS[pkg][1].XEON_E5_2660V4, pool_capacity=16, policy="scheduler")


def _report(rep):
    return (records(rep), report_numbers(rep), rep.domains, plain(rep.utilization_by_domain),
            rep.cross_domain_steals, len(rep.steal_events), plain(rep.mean_utilization_by_domain()))


def _run(graphs, queries=3, **cfg):
    """The burst through both engines; the reports must be equal. Returns the port's."""
    out = {}
    for pkg, (alg, core) in PKGS.items():
        out[pkg] = _engine(pkg).run_sessions(_mk_burst(alg, graphs[pkg]), sessions=8, queries_per_session=queries,
                                             config=core.EngineConfig(steal=True, fuse=True, **cfg))
    assert _report(out["torch"]) == _report(out["jax"])
    return out["torch"]


def test_engine_config_rejects_bad_domains():
    for kw in (dict(domains=0), dict(placement="nearest")):
        with pytest.raises(ValueError) as got:
            tcore.EngineConfig(**kw)
        with pytest.raises(ValueError) as want:
            jcore.EngineConfig(**kw)
        assert str(got.value) == str(want.value)


def test_domains_one_is_the_default_engine(clustered):
    base = _run(clustered)
    d1 = _run(clustered, domains=1, placement="round_robin", migration_penalty=False)
    assert d1.makespan_modeled_ns == base.makespan_modeled_ns
    assert [r.modeled_ns for r in d1.records] == [r.modeled_ns for r in base.records]
    assert d1.domains == 1
    assert d1.utilization_by_domain == []
    assert d1.cross_domain_steals == 0


def test_multi_domain_report_and_pool_restore(clustered):
    reps = {}
    for pkg, (alg, core) in PKGS.items():
        eng = _engine(pkg)
        assert eng.pool.domains == 1
        reps[pkg] = eng.run_sessions(_mk_burst(alg, clustered[pkg]), sessions=8, queries_per_session=2,
                                     config=core.EngineConfig(steal=True, fuse=True, domains=4))
        assert eng.pool.domains == 1
        assert eng.pool.in_use == 0
    assert _report(reps["torch"]) == _report(reps["jax"])
    rep = reps["torch"]
    assert len(rep.records) == 16
    assert all(r.finished_ns > 0 for r in rep.records)
    assert rep.domains == 4
    assert len(rep.utilization_by_domain) == 4
    assert all(len(line) > 0 for line in rep.utilization_by_domain)
    means = rep.mean_utilization_by_domain()
    assert len(means) == 4 and all(m > 0.0 for m in means)
    assert sum(means) <= 16.0
    assert 0.0 <= rep.cross_domain_steal_fraction() == reps["jax"].cross_domain_steal_fraction() <= 1.0


def test_round_robin_placement_pays_on_mismatched_sources(clustered):
    local = _run(clustered, domains=4, placement="locality")
    blind = _run(clustered, domains=4, placement="round_robin")
    nopen = _run(clustered, domains=4, placement="round_robin", migration_penalty=False)
    assert local.makespan_modeled_ns < blind.makespan_modeled_ns
    assert nopen.makespan_modeled_ns <= blind.makespan_modeled_ns


def test_cross_domain_steals_counted(clustered):
    rep = _run(clustered, domains=4, placement="round_robin")
    assert 0 <= rep.cross_domain_steals <= len(rep.steal_events)
