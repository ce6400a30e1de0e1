"""The port's Eq. 7–14 cost model, contention model and Algorithm 1
(``repro_torch.core``) against the JAX package's, test for test with
``tests/test_cost_model.py``: every latency, cost and ``ThreadBounds`` equal
to the reference's on the same inputs, and the reference's assertions held
on the port.

No counterpart: ``test_tpu_preset_bounds`` (the ``TPU_V5E_POD`` preset is
left out of the port on purpose; ``ROADMAP.md``, deliberate differences).
"""
import dataclasses
import math

import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

pytest.importorskip("torch")

import repro.core as jcore  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro.core.contention import HardwareModel as JHardwareModel  # noqa: E402
from repro_torch.core.contention import HardwareModel, MemoryLevel  # noqa: E402
from _torch_bench_rows import one_torch_thread  # noqa: E402,F401  (autouse: one torch thread a test)

HW = tcore.XEON_E5_2660V4
JHW = jcore.XEON_E5_2660V4


def work(core, frontier, deg=16.0, touched_frac=0.8, desc="BFS_TOP_DOWN"):
    d = getattr(core, desc)
    touched = frontier * deg * touched_frac
    return core.IterationWork(frontier=frontier, edges=frontier * deg, found=frontier * deg * 0.3,
                              touched=touched, m_bytes=core.touched_memory_bytes(d, touched, frontier))


def bounds(frontier, deg=16.0):
    """``thread_bounds`` of BFS top-down in both packages, checked equal."""
    tb = tcore.thread_bounds(tcore.BFS_TOP_DOWN, HW, work(tcore, frontier, deg))
    assert dataclasses.asdict(tb) == dataclasses.asdict(
        jcore.thread_bounds(jcore.BFS_TOP_DOWN, JHW, work(jcore, frontier, deg)))
    return tb


def test_preset_tables_equal_reference():
    assert tcore.PRESET_VERSION == jcore.PRESET_VERSION
    assert HW.to_payload() == JHW.to_payload()
    assert list(tcore.PRESETS) == ["xeon_e5_2660v4"] and tcore.PRESETS["xeon_e5_2660v4"] is HW


def test_atomic_t1_equals_mem():
    for m in (1e3, 1e5, 1e7, 1e9):
        assert HW.l_atomic(1, m) == JHW.l_atomic(1, m) and HW.l_mem(m) == JHW.l_mem(m)
        assert math.isclose(HW.l_atomic(1, m), HW.l_mem(m), rel_tol=1e-12)


@given(m=st.floats(16, 1e11), t=st.integers(1, 56))
@settings(max_examples=200, deadline=None)
def test_latency_positive_and_bounded(m, t):
    lat = HW.l_atomic(t, m)
    assert lat == JHW.l_atomic(t, m)
    assert lat > 0
    assert lat >= min(HW.lat_mem) - 1e-9
    assert lat <= HW.lat_atomic.max() + 1e-9


def test_latency_monotone_in_threads():
    for m in (1e3, 1e6, 1e8):
        lats = [HW.l_atomic(t, m) for t in (1, 2, 4, 8, 16, 32, 56)]
        assert lats == [JHW.l_atomic(t, m) for t in (1, 2, 4, 8, 16, 32, 56)]
        assert all(b >= a - 1e-9 for a, b in zip(lats, lats[1:]))


def test_interp_is_between_levels():
    for t in (2, 8, 28):
        l2, llc = HW.lat_atomic[1], HW.lat_atomic[2]
        m = 1 * 1024 * 1024
        lat = HW.l_atomic(t, m)
        assert lat == JHW.l_atomic(t, m)
        lo = min(HW._lat_at(l2, t), HW._lat_at(llc, t))
        hi = max(HW._lat_at(l2, t), HW._lat_at(llc, t))
        assert lo - 1e-9 <= lat <= hi + 1e-9


def test_oversized_m_rejected():
    with pytest.raises(ValueError) as got:
        HW.l_mem(1e15)
    with pytest.raises(ValueError) as want:
        JHW.l_mem(1e15)
    assert str(got.value) == str(want.value)


def test_calibration_roundtrip(tmp_path):
    levels = [MemoryLevel("L1", 2**15), MemoryLevel("DRAM", 2**34)]
    sizes, threads = [2**14, 2**30], [1, 2, 4]
    measured = np.array([[1.0, 2.0, 4.0], [50.0, 55.0, 60.0]])
    hw = tcore.calibrate_from_runs("test", levels, threads, sizes, measured)
    jhw = jcore.calibrate_from_runs("test", [jcore.MemoryLevel("L1", 2**15), jcore.MemoryLevel("DRAM", 2**34)],
                                    threads, sizes, measured)
    assert hw.to_payload() == jhw.to_payload()
    assert hw.l_atomic(1, 2**13) == pytest.approx(1.0)
    p = tmp_path / "hw.json"
    hw.save(str(p))
    hw2 = HardwareModel.load(str(p))
    assert hw2.l_atomic(4, 2**20) == pytest.approx(hw.l_atomic(4, 2**20))
    # the file either package writes loads in the other
    assert JHardwareModel.load(str(p)).to_payload() == hw2.to_payload()
    jhw.save(str(tmp_path / "jhw.json"))
    assert HardwareModel.load(str(tmp_path / "jhw.json")).to_payload() == hw.to_payload()


def test_push_costs_more_than_pull_parallel():
    c = {}
    for name, core, hw in (("jax", jcore, JHW), ("torch", tcore, HW)):
        c[name] = (core.c_vertex_total(core.PR_PUSH, hw, work(core, 100_000, desc="PR_PUSH"), t=28),
                   core.c_vertex_total(core.PR_PULL, hw, work(core, 100_000, desc="PR_PULL"), t=28))
    assert c["torch"] == c["jax"]
    assert c["torch"][0] > c["torch"][1]


def test_small_frontier_sequential():
    tb = bounds(32)
    assert not tb.parallel and tb.t_max == 0 and tb.n_packages == 1


def test_large_frontier_parallel():
    tb = bounds(500_000)
    assert tb.parallel and 2 <= tb.t_min <= tb.t_max <= 56
    assert tb.n_packages <= 8 * tb.t_max
    assert tb.cost_par_ns < tb.cost_seq_ns


@given(frontier=st.integers(1, 2_000_000))
@settings(max_examples=60, deadline=None)
def test_bounds_invariants(frontier):
    tb = bounds(frontier)
    if tb.parallel:
        assert 2 <= tb.t_min <= tb.t_max <= HW.max_threads
        assert tb.t_min & (tb.t_min - 1) == 0
        assert tb.t_max & (tb.t_max - 1) == 0
        assert tb.n_packages >= tb.t_max
        assert tb.n_packages <= 8 * tb.t_max
        assert tcore.parallel_beats_sequential(tcore.BFS_TOP_DOWN, HW, work(tcore, frontier), tb.t_max)
        assert jcore.parallel_beats_sequential(jcore.BFS_TOP_DOWN, JHW, work(jcore, frontier), tb.t_max)
    else:
        assert tb.t_min == 0 and tb.t_max == 0 and tb.n_packages == 1


def test_clamp_elastic():
    tb = bounds(500_000)
    jtb = jcore.thread_bounds(jcore.BFS_TOP_DOWN, JHW, work(jcore, 500_000))
    clamped = tb.clamp(tb.t_max // 2)
    assert dataclasses.asdict(clamped) == dataclasses.asdict(jtb.clamp(tb.t_max // 2))
    assert clamped.t_max <= tb.t_max // 2
    dead = tb.clamp(1)
    assert dataclasses.asdict(dead) == dataclasses.asdict(jtb.clamp(1))
    assert not dead.parallel


def test_iteration_cost_includes_overheads():
    seq = tcore.iteration_cost_ns(tcore.BFS_TOP_DOWN, HW, work(tcore, 100_000), 1)
    par = tcore.iteration_cost_ns(tcore.BFS_TOP_DOWN, HW, work(tcore, 100_000), 8)
    assert (seq, par) == (jcore.iteration_cost_ns(jcore.BFS_TOP_DOWN, JHW, work(jcore, 100_000), 1),
                          jcore.iteration_cost_ns(jcore.BFS_TOP_DOWN, JHW, work(jcore, 100_000), 8))
    assert par >= HW.c_para_startup_ns
    assert par < seq
