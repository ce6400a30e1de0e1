"""The reduction of a block of rounds traced by the program
(``progtrace``), and the program's own completion stamps against the
harness's, on the CPU."""
from __future__ import annotations

import pytest
import torch

from graphbench import harness, progtrace


def _recorder(spans, counters, offset_ns):
    from repro_torch.core import tracing

    rec = tracing.Recorder()
    rec.names, rec.starts, rec.ends, rec.parents, rec.keys = map(list, zip(*spans))
    rec.counters = counters
    rec.anchors = [(0, offset_ns), (1000, 1000 + offset_ns)]
    return rec


def test_idle_gaps_go_to_the_innermost_span():
    """One round (host 0..120) around one ``engine.round`` (10..110): an
    spmv launch at 30..40 inside ``backend.execute`` and one at 106..107
    outside it, an elementwise operation at 70..100, on an epoch clock
    5,000 ahead of the host's by the anchors; the marker, launched at 28,
    reads 5,002."""
    spans = [
        ["engine.round", 10, 110, -1, None],
        ["sched.package", 12, 25, 0, (0, 0)],
        ["backend.execute", 26, 105, 0, None],
        ["executor.apply", 45, 60, 2, None],
        ["host.sync", 50, 60, 3, None],
    ]
    rec = _recorder(spans, {"host_syncs": 1}, 5000)
    events = [(5030, 5040, "spmv_blocks_kernel"), (5070, 5100, "elementwise"),
              (5106, 5107, "spmv_blocks_kernel")]
    b = progtrace.program_block(rec, [(0, 120)], events, marker_host_ns=28)
    # gaps: 0..30 (middle 15: sched.package), 40..70 (55: host.sync),
    # 100..106 (103: backend.execute), 107..120 (113: past engine.round)
    assert b.idle_by_span == pytest.approx(
        {"sched.package": 30e-9, "host.sync": 30e-9, "backend.execute": 6e-9, progtrace.OUTSIDE: 13e-9})
    assert b.idle_s == pytest.approx(79e-9)
    assert (b.anchor_offset_ns, b.marker_offset_ns, b.offset_ns) == (5000, 5002, 5000)
    assert b.aligned_share == b.anchor_share == 0.5
    assert b.sched_self_pct == pytest.approx(100 * 13 / 120)
    assert b.executor_host_pct == pytest.approx(100 * 5 / 120)
    assert b.dispatch_host_ms == pytest.approx((79 - 15) * 1e-6)
    assert b.sync_wait_ms == pytest.approx(10e-6)
    assert b.host_syncs_per_step == 1
    assert sum(b.self_s.values()) == pytest.approx(100e-9)


def test_the_offset_is_fitted_to_the_launches():
    """Two steps, at host 1,000,000..2,000,000 and 3,000,000..4,000,000 ns;
    by the anchors their kernels would end 30 us past each step's end: the
    fitted offset moves them 30 us earlier, the nearest shift that puts
    both inside."""
    spans = [["engine.round", 0, 5_000_000, -1, None],
             ["backend.execute", 1_000_000, 2_000_000, 0, None],
             ["backend.execute", 3_000_000, 4_000_000, 0, None]]
    rec = _recorder(spans, {}, 7_000_000_000)
    base = 7_000_000_000
    events = [(base + 1_900_000, base + 2_030_000, "spmv_blocks_kernel"),
              (base + 3_500_000, base + 4_025_000, "spmv_blocks_kernel")]
    assert progtrace.fit_offset(spans, events, base) == (base + 30_000, 1.0, 0.0)
    b = progtrace.program_block(rec, [(0, 5_000_000)], events)
    assert b.offset_ns == base + 30_000 and b.aligned_share == 1.0
    assert b.idle_s == pytest.approx((5_000_000 - 130_000 - 525_000) / 1e9)


@pytest.mark.parametrize("late_ns, shift_us", [(2_950_000, 50), (3_550_000, 0)])
def test_the_anchors_stand_where_no_offset_fits(late_ns, shift_us):
    """Steps at host 0..1 ms and 2..3 ms; one 100 us launch inside the
    first at the anchors' offset, one starting at ``late_ns``. From 2.95 ms
    a shift of 50 us puts both inside; from 3.55 ms no shift puts both
    inside their steps, and the anchors stand."""
    spans = [["backend.execute", 0, 1_000_000, -1, None], ["backend.execute", 2_000_000, 3_000_000, -1, None]]
    events = [(500_000, 600_000, "spmv_blocks_kernel"), (late_ns, late_ns + 100_000, "spmv_blocks_kernel")]
    assert progtrace.fit_offset(spans, events, 0) == (shift_us * 1000, 1.0 if shift_us else 0.5, 0.5)


def test_a_block_without_a_profile_gives_the_host_readings():
    rec = _recorder([["engine.round", 0, 10, -1, None]], {}, 0)
    b = progtrace.program_block(rec, [(0, 10)])
    assert b.idle_by_span is None and b.sched_self_pct == 0 and b.dispatch_host_ms is None


@pytest.mark.parametrize("kind", ["pagerank", "bfs"])
def test_program_completion_stamp_follows_the_harness_stamp(kind):
    """``QueryRecord.finished_wall_ns`` is taken after the harness's
    ``Stamped`` executor saw the query done, with no engine event between:
    no step, no executor call and no scheduling span starts in between."""
    import repro_torch.algorithms as alg
    from repro_torch import core
    from repro_torch.core import tracing
    from repro_torch.graph import grid_graph

    graph = grid_graph(20, device="cpu")
    made = []

    def make(s, q):
        if kind == "pagerank":
            ex = harness.stamping(alg.PageRankExecutor)(graph, mode="pull", max_iters=5, tol=0)
        else:
            ex = harness.stamping(alg.BFSExecutor)(graph, int(torch.randint(0, 400, (1,), generator=gen)))
        made.append(ex)
        return ex

    gen = torch.Generator().manual_seed(3)
    eng = core.MultiQueryEngine(core.XEON_E5_2660V4, policy="scheduler")
    rec = tracing.start()
    try:
        rep = eng.run_sessions(make, sessions=16, queries_per_session=1,
                               config=core.EngineConfig(steal=True, backend=core.CudaBackend()))
    finally:
        tracing.stop()
    starts = sorted(s[1] for s in rec.spans if s[0] != "engine.round")
    for r, ex in zip(rep.records, made):
        assert ex.stamp_ns is not None and ex.stamp_ns <= r.finished_wall_ns
        assert not [t for t in starts if ex.stamp_ns < t < r.finished_wall_ns]
