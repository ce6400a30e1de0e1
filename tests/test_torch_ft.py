"""``repro_torch.ft`` against ``repro.ft`` on the same fake clock: the
heartbeat monitor's deaths and rejoins, the straggler policy's reissues, the
elastic plan's reshard, and ``on_capacity_change``'s events, pool capacity
and clamped bounds. The counterparts of ``tests/test_substrates.py``'s three
fault-tolerance tests (heartbeat and rejoin, straggler reissue, elastic
reshard), run against both packages."""
import dataclasses

import pytest

pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
import repro.ft as jft  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
import repro_torch.ft as tft  # noqa: E402
from _hypothesis_compat import given, settings, st  # noqa: E402
from _torch_bench_rows import one_torch_thread  # noqa: E402,F401  (autouse: one torch thread a test)

PKGS = {"jax": (jft, jcore), "torch": (tft, tcore)}


def _clock():
    t = [0.0]
    return t, (lambda: t[0])


def _heartbeats(ft):
    t, clock = _clock()
    hm = ft.HeartbeatMonitor(["a", "b", "c"], timeout_s=5, clock=clock)
    seen = []
    t[0] = 3.0
    hm.beat("a")
    hm.beat("b")
    t[0] = 7.0
    seen.append(("check", hm.check(), list(hm.alive)))
    hm.beat("c")  # beats from dead groups are ignored
    seen.append(("beat dead", hm.check(), list(hm.alive)))
    t[0] = 8.5
    seen.append(("a, b late", hm.check(), list(hm.alive)))
    hm.rejoin("c")
    seen.append(("rejoin", hm.check(), list(hm.alive)))
    t[0] = 13.6
    seen.append(("c late again", hm.check(), list(hm.alive)))
    return seen


def test_heartbeat_and_rejoin_equal_reference():
    got, want = _heartbeats(tft), _heartbeats(jft)
    assert got == want
    # the reference test's assertions, on the port
    assert got[0] == ("check", ["c"], ["a", "b"])
    assert "c" not in got[1][2] and "c" in got[3][2]
    assert got[2][1] == ["a", "b"] and got[4] == ("c late again", ["c"], [])
    assert tft.HeartbeatMonitor(["x"]).timeout_s == jft.HeartbeatMonitor(["x"]).timeout_s == 10.0


def _stragglers(ft, slow_factor=3.0, min_samples=3):
    t, clock = _clock()
    sp = ft.StragglerPolicy(slow_factor=slow_factor, min_samples=min_samples, clock=clock)
    seen = []
    for p in range(5):
        sp.started(p)
    t[0] = 1.0
    for p in range(3):
        sp.finished(p)
    sp.finished(0)  # a duplicate completion changes nothing
    seen.append(sp.to_reissue())
    t[0] = 3.5
    sp.finished(99)  # an unknown package is ignored
    seen.append(sp.to_reissue())
    t[0] = 10.0
    seen.append(sp.to_reissue())
    sp.finished(4)
    seen.append(sp.to_reissue())
    sp.started(3)  # a reissued package restarts its timing
    seen.append(sp.to_reissue())
    return seen


def test_straggler_reissue_equals_reference():
    got = _stragglers(tft)
    assert got == _stragglers(jft)
    assert got[0] == [] and got[2] == [3, 4] and got[3] == [3] and got[4] == []
    assert _stragglers(tft, min_samples=4) == _stragglers(jft, min_samples=4)
    assert _stragglers(tft, slow_factor=50.0) == _stragglers(jft, slow_factor=50.0)
    assert (tft.StragglerPolicy().slow_factor, tft.StragglerPolicy().min_samples) == (3.0, 4)
    assert dataclasses.asdict(tft.PackageTiming(1, 2.0)) == dataclasses.asdict(jft.fault_tolerance.PackageTiming(1, 2.0))


@settings(max_examples=40, deadline=None)
@given(batch=st.integers(0, 4096), survivors=st.integers(1, 64))
def test_elastic_reshard_equals_reference(batch, survivors):
    shards = tft.ElasticPlan.reshard_batch(batch, survivors)
    assert shards == jft.ElasticPlan.reshard_batch(batch, survivors)
    assert len(shards) == survivors and shards[0][0] == 0 and shards[-1][1] == batch
    assert sum(b - a for a, b in shards) == batch
    assert all(b >= a for a, b in shards)


def _bounds(core, p):
    """Real Algorithm 1 bounds on a graph-sized workload, plus a sequential one."""
    out = []
    for frontier in (200.0, 20_000.0, 2_000_000.0):
        touched = frontier * 16 * 0.8
        work = core.IterationWork(frontier=frontier, edges=frontier * 16, found=frontier * 16 * 0.3,
                                  touched=touched,
                                  m_bytes=core.touched_memory_bytes(core.BFS_TOP_DOWN, touched, frontier))
        out.append(core.thread_bounds(core.BFS_TOP_DOWN, core.XEON_E5_2660V4, work, p))
    assert out[-1].parallel and out[-1].t_max >= 8
    out.append(dataclasses.replace(out[-1], parallel=False))
    return out


def _elastic(ft, core, changes):
    pool = core.WorkerPool(16)
    plan = ft.ElasticPlan(pool)
    bounds = _bounds(core, 16)
    seen = []
    for cap in changes:
        bounds = plan.on_capacity_change(cap, bounds)
        seen.append((pool.capacity, pool.available, [dataclasses.asdict(b) for b in bounds]))
    return plan.events, seen


@pytest.mark.parametrize("changes", [(8, 3, 1, 16), (32, 16, 5), (2, 2, 7)])
def test_on_capacity_change_equals_reference(changes):
    got, want = _elastic(tft, tcore, changes), _elastic(jft, jcore, changes)
    assert got == want
    events, seen = got
    assert [e[1] for e in events] == list(changes)
    cap_seen = 16
    for (cap, avail, bounds), new in zip(seen, changes):
        assert cap == avail == new
        cap_seen = min(cap_seen, new)  # a clamp never widens again
        assert all(not b["parallel"] or b["t_max"] <= cap_seen for b in bounds)


def test_on_capacity_change_refuses_an_empty_pool():
    for ft, core in PKGS.values():
        plan = ft.ElasticPlan(core.WorkerPool(4))
        with pytest.raises(ValueError, match="capacity"):
            plan.on_capacity_change(0, [])
        assert plan.events == [] and plan.pool.capacity == 4
