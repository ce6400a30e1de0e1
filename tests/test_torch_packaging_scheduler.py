"""The port's §4.2 work packaging and §4.3 selective sequential execution
(``repro_torch.core``) against the JAX package's, test for test with
``tests/test_packaging_scheduler.py``: the same packages (bounds, order,
mode), tables, scheduler callbacks and ``ScheduleTrace`` decisions in both
packages, and the reference's assertions held on the port."""
import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from _torch_parity import plain, port_graph  # noqa: E402
from _torch_bench_rows import one_torch_thread  # noqa: E402,F401  (autouse: one torch thread a test)

PKGS = {"jax": jcore, "torch": tcore}


def bounds(core, parallel=True, t_min=2, t_max=8, n_packages=32):
    return core.ThreadBounds(t_min=t_min, t_max=t_max, n_packages=n_packages, v_min_parallel=10,
                             parallel=parallel, cost_seq_ns=1e6, cost_par_ns=2e5)


def packages(degrees, variance_ratio, **kw):
    """The port's packages, checked equal to the reference's."""
    b = kw.pop("b", {})
    got = tcore.make_packages(degrees, bounds(tcore, **b), variance_ratio=variance_ratio, **kw)
    want = jcore.make_packages(degrees, bounds(jcore, **b), variance_ratio=variance_ratio, **kw)
    assert plain(got) == plain(want)
    return got


@given(n=st.integers(1, 5000), npkg=st.integers(2, 64), seed=st.integers(0, 100), ratio=st.floats(1.0, 50.0))
@settings(max_examples=100, deadline=None)
def test_packages_partition_exactly(n, npkg, seed, ratio):
    rng = np.random.default_rng(seed)
    degrees = rng.zipf(1.5, size=n).clip(0, 10_000)
    pkgs = packages(degrees, ratio, b=dict(n_packages=npkg))
    assert pkgs.covers(n)
    assert (np.diff(pkgs.bounds) > 0).all()
    assert sorted(pkgs.order.tolist()) == list(range(pkgs.n_packages))
    seen = np.zeros(n, bool)
    for p in pkgs.order:
        lo, hi = pkgs.bounds[p], pkgs.bounds[p + 1]
        assert not seen[lo:hi].any()
        seen[lo:hi] = True
    assert seen.all()


def test_cost_based_balances_work():
    rng = np.random.default_rng(1)
    degrees = rng.zipf(1.6, size=2000).clip(0, 5000)
    pkgs = packages(degrees, 100.0, b=dict(n_packages=16))
    assert pkgs.mode == "cost_based"
    work = [degrees[a:b].sum() for a, b in zip(pkgs.bounds[:-1], pkgs.bounds[1:])]
    ordered = [work[p] for p in pkgs.order]
    assert ordered[0] == max(work)
    assert max(work) <= degrees.sum() / pkgs.n_packages + degrees.max()


def test_static_mode_for_low_variance():
    pkgs = packages(np.full(10_000, 8), 1.05, b=dict(n_packages=16))
    assert pkgs.mode == "static"
    sizes = pkgs.sizes()
    assert sizes.max() - sizes.min() <= 1


def test_sample_degrees_force_static():
    pkgs = packages(np.array([100, 1, 1]), 50.0, b=dict(n_packages=8), frontier_size=1000)
    assert pkgs.mode == "static"
    assert pkgs.covers(1000)


def test_single_package_when_sequential():
    pkgs = packages(np.arange(100), 2.0, b=dict(parallel=False))
    assert pkgs.mode == "single" and pkgs.n_packages == 1


def test_packages_to_table_fixed_shape():
    degrees = np.random.default_rng(0).integers(1, 50, 300)
    pkgs = packages(degrees, 1.0, b=dict(n_packages=16))
    starts, sizes = tcore.packages_to_table(pkgs, max_packages=64)
    assert plain((starts, sizes)) == plain(jcore.packages_to_table(
        jcore.make_packages(degrees, bounds(jcore, n_packages=16), variance_ratio=1.0), max_packages=64))
    assert starts.shape == (64,) and sizes.shape == (64,)
    assert sizes[: pkgs.n_packages].sum() == 300
    assert (sizes[pkgs.n_packages:] == 0).all()


def test_packages_to_table_rejects_overflow():
    degrees = np.random.default_rng(0).integers(1, 50, 300)
    pkgs = packages(degrees, 1.0, b=dict(n_packages=16))
    assert pkgs.n_packages == 16
    with pytest.raises(ValueError, match="exceed"):
        tcore.packages_to_table(pkgs, max_packages=8)
    starts, sizes = tcore.packages_to_table(pkgs, max_packages=16)
    assert sizes.sum() == 300


# ---------------- scheduler (§4.3) ----------------

def run_sched(core, pool, b, n=8):
    degrees = np.full(200, 4)
    pkgs = core.make_packages(degrees, b, variance_ratio=1.0)
    ran = {"par": [], "seq": []}
    sched = core.PackageScheduler(pool, seq_package_limit=2)
    trace = sched.run(pkgs, b, lambda batch, t: ran["par"].extend((int(p), t) for p in batch),
                      lambda batch: ran["seq"].extend(int(p) for p in batch))
    return ran, trace, pkgs


def both(scenario):
    """Run ``scenario(core)`` in both packages; its results must be equal."""
    out = {name: scenario(core) for name, core in PKGS.items()}
    assert plain(out["torch"]) == plain(out["jax"])
    return out["torch"]


def test_parallel_when_workers_available():
    def scenario(core):
        pool = core.WorkerPool(16)
        ran, trace, pkgs = run_sched(core, pool, bounds(core, t_min=2, t_max=8, n_packages=8))
        return ran, trace, pkgs, pool.available

    ran, trace, pkgs, available = both(scenario)
    assert len(ran["par"]) == pkgs.n_packages and not ran["seq"]
    assert trace.max_workers == 8
    assert available == 16


def test_sequential_fallback_under_contention():
    def scenario(core):
        pool = core.WorkerPool(16)
        taken = pool.request(15)
        ran, trace, _ = run_sched(core, pool, bounds(core, t_min=4, t_max=8, n_packages=8))
        pool.release(taken)
        return ran, trace, pool.available

    ran, trace, available = both(scenario)
    assert ran["seq"] and not ran["par"]
    assert trace.released_early
    assert available == 16


def test_mid_run_reevaluation_picks_up_freed_workers():
    def scenario(core):
        pool = core.WorkerPool(8)
        taken = pool.request(7)
        b = bounds(core, t_min=4, t_max=8, n_packages=8)
        pkgs = core.make_packages(np.full(200, 4), b, variance_ratio=1.0)
        sched = core.PackageScheduler(pool, seq_package_limit=4)
        ran = {"par": 0, "seq": 0}

        def seq(batch):
            ran["seq"] += len(batch)
            pool.release(taken) if pool.available == 0 else None

        trace = sched.run(pkgs, b, lambda batch, t: ran.__setitem__("par", ran["par"] + len(batch)), seq)
        return ran, trace

    ran, _ = both(scenario)
    assert ran["seq"] >= 1 and ran["par"] >= 1


def test_sequential_task_takes_one_worker():
    def scenario(core):
        pool = core.WorkerPool(4)
        ran, trace, _ = run_sched(core, pool, bounds(core, parallel=False, t_min=0, t_max=0, n_packages=1))
        return ran, trace, pool.available

    ran, _, available = both(scenario)
    assert not ran["par"] and ran["seq"]
    assert available == 4


def test_prepare_iteration_end_to_end(small_rmat):
    tg = port_graph(small_rmat)
    stats = tg.stats
    prep = tcore.prepare_iteration(tcore.BFS_TOP_DOWN, tcore.XEON_E5_2660V4, stats, 500,
                                   frontier_degrees=tg.out_degrees().numpy()[:500], unvisited=stats.v_reach)
    want = jcore.prepare_iteration(jcore.BFS_TOP_DOWN, jcore.XEON_E5_2660V4, small_rmat.stats, 500,
                                   frontier_degrees=np.asarray(small_rmat.out_degrees())[:500],
                                   unvisited=small_rmat.stats.v_reach)
    assert plain(prep) == plain(want)
    assert prep.work.edges > 0
    assert prep.packages.covers(500)
