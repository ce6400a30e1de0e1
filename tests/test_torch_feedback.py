"""The port's width-aware cost feedback (§4.4 table) and its planning
consumers against the JAX package's, test for test with
``tests/test_feedback.py``. Each scenario runs in both packages: every
correction, ratio and the whole ``CostFeedback`` state (the EWMA tables,
censor counts, raw pairs), gang and thief widths, prepared bounds, refit
presets and engine reports (width histograms included) must be equal, and
the reference's assertions hold on the port."""
import math

import numpy as np
import pytest

pytest.importorskip("torch")

from _hypothesis_compat import given, settings, st  # noqa: E402
from _torch_parity import both, packages, plain, port_graph, report_view  # noqa: E402
from _torch_bench_rows import one_torch_thread  # noqa: E402,F401  (autouse: one torch thread a test)


@pytest.fixture(scope="module")
def graphs(small_rmat):
    return {"jax": small_rmat, "torch": port_graph(small_rmat)}


@pytest.fixture(scope="module")
def graphs12(medium_rmat):
    return {"jax": medium_rmat, "torch": port_graph(medium_rmat)}


def _fb(scenario):
    """Run ``scenario(core) -> (values, feedback)`` in both packages; values
    and the feedback tables must be equal. Returns the port's values."""
    return both(lambda alg, core, pkg: scenario(core))[0][0]


# ---------------- hierarchical fallback (table unit tests) ----------------

def test_cold_start_correction_is_one():
    def scenario(core):
        fb = core.CostFeedback()
        return [fb.correction("a", True), fb.correction("a", False), fb.correction("a", True, width=16),
                fb.width_ratio("a", 16)], fb

    assert _fb(scenario) == [1.0, 1.0, 1.0, 1.0]


def test_exact_width_hit():
    def scenario(core):
        fb = core.CostFeedback(alpha=1.0)
        fb.observe("a", "parallel", width=8, modeled_ns=1.0, measured_ns=2.0)
        seen = [fb.correction("a", True, width=8)]
        fb.observe("a", "parallel", modeled_ns=1.0, measured_ns=0.5)
        return seen + [fb.correction("a", True, width=8)], fb

    assert _fb(scenario) == [pytest.approx(2.0)] * 2


def test_pow2_bucket_fallback():
    def scenario(core):
        fb = core.CostFeedback(alpha=1.0)
        fb.observe("a", "parallel", width=8, modeled_ns=1.0, measured_ns=2.0)
        fb2 = core.CostFeedback(alpha=1.0)
        fb2.observe("a", "parallel", width=12, modeled_ns=1.0, measured_ns=3.0)
        return [fb.correction("a", True, width=13)] + [fb2.correction("a", True, width=w) for w in (12, 9, 8)], (fb, fb2)

    assert _fb(scenario) == [pytest.approx(2.0)] + [pytest.approx(3.0)] * 3


def test_mode_level_fallback():
    def scenario(core):
        fb = core.CostFeedback(alpha=1.0)
        fb.observe("a", "parallel", modeled_ns=1.0, measured_ns=4.0)
        return [fb.correction("a", True, width=16), fb.correction("a", False, width=1)], fb

    assert _fb(scenario) == [pytest.approx(4.0), 1.0]


def test_width_ratio_is_relative_to_mode_scalar():
    def scenario(core):
        fb = core.CostFeedback(alpha=1.0)
        fb.observe("a", "parallel", modeled_ns=1.0, measured_ns=2.0)
        fb.observe("a", "parallel", width=16, modeled_ns=1.0, measured_ns=4.0)
        seen = [fb.width_ratio("a", 16)]
        fb.observe("a", "parallel", width=4, modeled_ns=1.0, measured_ns=2.0)
        return seen + [fb.width_ratio("a", 4)], fb

    assert _fb(scenario) == [pytest.approx(2.0), pytest.approx(1.0)]


def test_predict_uses_width_when_given():
    def scenario(core):
        fb = core.CostFeedback(alpha=1.0)
        fb.observe("a", "parallel", modeled_ns=1.0, measured_ns=2.0)
        fb.observe("a", "parallel", width=8, modeled_ns=1.0, measured_ns=4.0)
        return [fb.predict("a", True, 100.0), fb.predict("a", True, 100.0, width=8)], fb

    assert _fb(scenario) == [pytest.approx(200.0), pytest.approx(400.0)]


# ---------------- removed legacy signatures ----------------

def _raises_alike(exc, call):
    msgs = []
    for _, core in packages().values():
        with pytest.raises(exc) as err:
            call(core)
        msgs.append(str(err.value))
    return msgs


def test_legacy_bool_observe_is_gone():
    for mode, measured in ((True, 2.0), (False, 0.5)):
        msgs = _raises_alike(ValueError, lambda core: core.CostFeedback(alpha=1.0).observe(
            "a", mode, modeled_ns=1.0, measured_ns=measured))
        assert msgs[0] == msgs[1]


def test_legacy_observe_width_is_gone():
    def scenario(core):
        fb = core.CostFeedback(alpha=1.0)
        gone = not hasattr(fb, "observe_width")
        fb.observe("a", "parallel", width=8, modeled_ns=1.0, measured_ns=4.0)
        return [gone, fb.correction("a", True, width=8), fb.width_observations], fb

    assert _fb(scenario) == [True, pytest.approx(4.0), 1]


def test_unified_observe_rejects_bad_arguments():
    msgs = _raises_alike(ValueError, lambda core: core.CostFeedback().observe(
        "a", "diagonal", modeled_ns=1.0, measured_ns=1.0))
    assert msgs[0] == msgs[1]
    _raises_alike(TypeError, lambda core: core.CostFeedback().observe("a", "parallel", modeled_ns=1.0))


# ---------------- clamp regression ----------------

def test_correction_clamped_even_when_ewma_overshoots():
    def scenario(core):
        fb = core.CostFeedback(alpha=1.6, clip=4.0)
        fb.observe("a", "parallel", modeled_ns=1.0, measured_ns=1e9)
        fb2 = core.CostFeedback(alpha=1.6, clip=4.0)
        fb2.observe("a", "parallel", width=8, modeled_ns=1e9, measured_ns=1.0)
        return [fb._log_corr[("a", True)], fb.correction("a", True), fb2.correction("a", True, width=8)], (fb, fb2)

    raw, corr, corr2 = _fb(scenario)
    assert raw > math.log(4.0)
    assert corr <= 4.0
    assert corr2 >= 1 / 4.0


@settings(max_examples=60, deadline=None)
@given(n=st.integers(1, 30), seed=st.integers(0, 10_000), alpha=st.floats(0.05, 1.0))
def test_corrections_bounded_under_arbitrary_observations(n, seed, alpha):
    def scenario(core):
        rng = np.random.default_rng(seed)
        fb = core.CostFeedback(alpha=alpha, clip=8.0)
        for _ in range(n):
            modeled, measured = float(10 ** rng.uniform(-3, 9)), float(10 ** rng.uniform(-3, 9))
            if rng.integers(2):
                fb.observe("a", "parallel" if rng.integers(2) else "sequential", modeled_ns=modeled,
                           measured_ns=measured)
            else:
                fb.observe("a", "parallel", width=int(rng.integers(1, 64)), modeled_ns=modeled, measured_ns=measured)
        corr = [fb.correction("a", par, width=w) for par in (False, True) for w in (None, 1, 2, 3, 8, 12, 16, 64)]
        return [corr, [fb.width_ratio("a", w) for w in (1, 2, 8, 12, 64)]], fb

    corr, ratios = _fb(scenario)
    assert all(1 / 8.0 - 1e-12 <= c <= 8.0 + 1e-12 for c in corr)
    assert all(r > 0 for r in ratios)


# ---------------- censoring ----------------

def test_censored_signal_yields_neutral_width_ratio():
    def scenario(core):
        fb = core.CostFeedback(alpha=1.0, clip=8.0)
        fb.observe("a", "parallel", modeled_ns=1.0, measured_ns=100.0)
        fb.observe("a", "parallel", width=16, modeled_ns=1.0, measured_ns=2.0)
        fb2 = core.CostFeedback(alpha=1.0, clip=8.0)
        fb2.observe("a", "parallel", modeled_ns=1.0, measured_ns=2.0)
        fb2.observe("a", "parallel", width=16, modeled_ns=1.0, measured_ns=100.0)
        return [fb.width_ratio("a", 16), fb2.width_ratio("a", 16), fb2.correction("a", True, width=16)], (fb, fb2)

    assert _fb(scenario) == [1.0, 1.0, pytest.approx(8.0)]


def test_uncensored_signal_flows_through():
    def scenario(core):
        fb = core.CostFeedback(alpha=1.0, clip=8.0)
        fb.observe("a", "parallel", modeled_ns=1.0, measured_ns=2.0)
        fb.observe("a", "parallel", width=16, modeled_ns=1.0, measured_ns=6.0)
        return [fb.width_ratio("a", 16)], fb

    assert _fb(scenario) == [pytest.approx(3.0)]


def test_width_one_cancels_common_mode_in_parallel_workload():
    def scenario(core):
        fb = core.CostFeedback(alpha=1.0)
        fb.observe("pr", "parallel", modeled_ns=1.0, measured_ns=3.0)
        for w in (1, 8, 16):
            fb.observe("pr", "parallel", width=w, modeled_ns=1.0, measured_ns=3.0)
        seen = [fb.width_ratio("pr", w) for w in (1, 8, 16)]
        fb.observe("pr", "parallel", width=16, modeled_ns=1.0, measured_ns=7.5)
        return seen + [fb.width_ratio("pr", 16)], fb

    *flat, worse = _fb(scenario)
    assert flat == [pytest.approx(1.0)] * 3
    assert worse > 1.0


# ---------------- planning consumers ----------------

def _staged(core, graph, members=6, p=16):
    prep = core.prepare_iteration(core.PR_PULL, core.XEON_E5_2660V4, graph.stats, graph.num_vertices,
                                  frontier_degrees=np.asarray(graph.out_degrees()), p=p)
    return [(None, prep, prep.bounds)] * members, prep


def _seeded_fb(core, penalties=((1, 1.0), (2, 1.0), (4, 1.0), (8, 3.0), (16, 8.0))):
    fb = core.CostFeedback()
    for w, penalty in penalties:
        for _ in range(32):
            fb.observe(core.PR_PULL.name, "parallel", width=w, modeled_ns=1.0, measured_ns=penalty)
    return fb


def test_plan_gang_width_cold_matches_capped_behaviour(graphs12):
    def scenario(alg, core, pkg):
        staged, prep = _staged(core, graphs12[pkg])
        return (core.plan_gang_width(staged, core.PR_PULL, core.XEON_E5_2660V4, capacity=16, feedback=None),
                min(sum(max(b.t_max, 1) for _, _, b in staged), 16), prep)

    cold, capped, _ = both(scenario)[0]
    assert 2 <= cold <= capped


def test_plan_gang_width_narrows_under_measured_inefficiency(graphs12):
    def scenario(alg, core, pkg):
        staged, _ = _staged(core, graphs12[pkg])
        hw = core.XEON_E5_2660V4
        return (core.plan_gang_width(staged, core.PR_PULL, hw, capacity=16, feedback=None),
                core.plan_gang_width(staged, core.PR_PULL, hw, capacity=16, feedback=_seeded_fb(core)))

    cold, seeded = both(scenario)[0]
    assert seeded < cold
    assert seeded >= 2


def test_thief_gang_width_cold_takes_max_pow2():
    def scenario(alg, core, pkg):
        fb, width = core.CostFeedback(), core.StealRegistry.thief_gang_width
        return [width(fb, "x", 16, 16), width(fb, "x", 16, 5), width(fb, "x", 3, 16), width(fb, "x", 16, 0)]

    assert both(scenario)[0] == [16, 4, 2, 0]


def test_thief_gang_width_narrows_under_measured_inefficiency():
    def scenario(alg, core, pkg):
        fb = _seeded_fb(core)
        return [core.StealRegistry.thief_gang_width(fb, core.PR_PULL.name, t, 16) for t in (16, 8, 4)], fb

    widths, _ = both(scenario)[0]
    assert 1 <= widths[0] < 16


def test_prepare_iteration_consults_width_table(graphs):
    def scenario(alg, core, pkg):
        g, hw = graphs[pkg], core.XEON_E5_2660V4
        deg = np.asarray(g.out_degrees())
        base = core.prepare_iteration(core.PR_PULL, hw, g.stats, g.num_vertices, frontier_degrees=deg, p=16)
        fb = core.CostFeedback()
        for _ in range(32):
            for w in (8, 16):
                fb.observe(core.PR_PULL.name, "parallel", width=w, modeled_ns=1.0, measured_ns=7.9)
            for w in (1, 2, 4):
                fb.observe(core.PR_PULL.name, "parallel", width=w, modeled_ns=1.0, measured_ns=1.0)
        corrected = core.prepare_iteration(core.PR_PULL, hw, g.stats, g.num_vertices, frontier_degrees=deg, p=16,
                                           feedback=fb)
        return base, corrected

    base, corrected = both(scenario)[0]
    assert corrected.bounds.t_max <= base.bounds.t_max
    assert corrected.bounds.t_max < 8 or not corrected.bounds.parallel


def test_thread_bounds_identity_with_unit_correction(graphs):
    def scenario(alg, core, pkg):
        g, hw = graphs[pkg], core.XEON_E5_2660V4
        prep = core.prepare_iteration(core.PR_PULL, hw, g.stats, g.num_vertices,
                                      frontier_degrees=np.asarray(g.out_degrees()), p=16)
        return (core.thread_bounds(core.PR_PULL, hw, prep.work, p=16),
                core.thread_bounds(core.PR_PULL, hw, prep.work, p=16, width_correction=lambda t: 1.0))

    base, unit = both(scenario)[0]
    assert base == unit


# ---------------- engine integration ----------------

def _mixed_mk(alg, graph):
    hubs = np.argsort(-np.asarray(graph.out_degrees()))
    return lambda s, q: (alg.PageRankExecutor(graph, mode="pull", max_iters=3, tol=0) if s == 0
                         else alg.BFSExecutor(graph, int(hubs[s % 4])))


def _view(out):
    rep, fb, *rest = out
    return report_view(rep), plain(fb), rep.width_histogram(), plain(rest)


class _Fusion:
    """A ``FusionConfig`` stand-in that each engine's ``EngineConfig``
    resolves to its own package's type."""

    def __init__(self, hold_ns):
        self.hold_ns = hold_ns


def _run(graphs, *, feedback, wfb=True, backend=None, **cfg):
    """The mixed burst in both engines: reports, width histograms and the
    feedback tables equal. Returns the port's (report, feedback, engine
    preset payload, whether the preset is still the built-in one)."""

    def scenario(alg, core, pkg):
        fb = core.CostFeedback() if feedback else None
        eng = core.MultiQueryEngine(core.XEON_E5_2660V4, pool_capacity=8, policy="scheduler", feedback=fb)
        kw = {k: core.FusionConfig(hold_ns=v.hold_ns) if isinstance(v, _Fusion) else v for k, v in cfg.items()}
        if backend is not None:
            kw["backend"] = backend(core)
        rep = eng.run_sessions(_mixed_mk(alg, graphs[pkg]), sessions=4, queries_per_session=1,
                               config=core.EngineConfig(width_feedback=wfb, **kw))
        return rep, fb, eng.hw.to_payload(), eng.hw is core.XEON_E5_2660V4

    return both(scenario, _view)[0]


def test_width_feedback_off_is_inert(graphs):
    cfg = dict(steal=True, fuse=True, fusion=_Fusion(2e4))
    rep_off, fb, *_ = _run(graphs, feedback=True, wfb=False, **cfg)
    rep_none, *_ = _run(graphs, feedback=False, wfb=True, **cfg)
    assert fb.width_observations == 0
    assert [r.modeled_ns for r in rep_off.records] == [r.modeled_ns for r in rep_none.records]
    assert rep_off.makespan_modeled_ns == rep_none.makespan_modeled_ns
    assert rep_off.width_histogram() == rep_none.width_histogram()


def test_width_feedback_on_populates_table_from_all_paths(graphs):
    rep, fb, *_ = _run(graphs, feedback=True, steal=True, fuse=True, fusion=_Fusion(2e4))
    assert fb.width_observations > 0
    assert rep.total_edges > 0
    for (algo, w) in list(fb._log_width):
        assert 1 / fb.clip <= fb.correction(algo, w >= 2, width=w) <= fb.clip
    assert fb.observations == sum(r.iterations for r in rep.records)


def test_engine_width_histogram_reports_delivered_widths(graphs):
    rep, *_ = _run(graphs, feedback=False, steal=True)
    hist = rep.width_histogram()
    assert hist and all(w >= 1 and n >= 1 for w, n in hist.items())
    assert sum(hist.values()) == sum(len(t.runs) for r in rep.records for t in r.traces)


# ---------------- censor-triggered recalibration ----------------

def test_censor_gate_trips_only_on_predominant_clipping():
    def scenario(core):
        fb = core.CostFeedback()
        seen = [fb.censor_tripped()]
        for _ in range(10):
            fb.observe("a", "parallel", width=8, modeled_ns=1.0, measured_ns=1.5)
        seen.append(fb.censor_tripped())
        fb2 = core.CostFeedback()
        for _ in range(10):
            fb2.observe("a", "parallel", width=8, modeled_ns=1.0, measured_ns=1e3)
        seen += [fb2.censor_tripped(), fb2.censor_tripped(min_observations=11), fb2.recalibration_pairs()]
        fb2.reset_width_state()
        seen += [fb2.censor_tripped(), fb2.recalibration_pairs(), fb2.width_ratio("a", 8)]
        return seen, (fb, fb2)

    cold, in_window, tripped, few, pairs, after, pairs_after, ratio = _fb(scenario)
    assert not cold and not in_window and tripped and not few
    assert len(pairs) == 10 and all(tuple(p) == (8, 1.0, 1e3) for p in pairs)
    assert not after and pairs_after == [] and ratio == 1.0


def test_recalibrate_preset_scales_latencies_to_the_host():
    def scenario(alg, core, pkg):
        hw = core.XEON_E5_2660V4
        same = [core.recalibrate_preset(hw, []) is hw, core.recalibrate_preset(hw, [(4, 0.0, 1.0)]) is hw]
        new = core.recalibrate_preset(hw, [(t, 1.0, 20.0) for t in hw.thread_counts for _ in range(3)])
        return same, new is not hw, new.to_payload()

    same, fresh, _ = both(scenario)[0]
    assert same == [True, True] and fresh
    from repro_torch.core import XEON_E5_2660V4 as hw, recalibrate_preset

    new = recalibrate_preset(hw, [(t, 1.0, 20.0) for t in hw.thread_counts for _ in range(3)])
    for t in hw.thread_counts:
        for lvl in hw.levels:
            m = 0.5 * lvl.capacity
            assert new.l_atomic(t, m) == pytest.approx(20.0 * hw.l_atomic(t, m), rel=0.05)


def test_recalibrate_preset_per_width_offsets():
    def scenario(alg, core, pkg):
        hw = core.XEON_E5_2660V4
        ts = hw.thread_counts
        new = core.recalibrate_preset(hw, [(ts[0], 1.0, 10.0)] * 5 + [(ts[-1], 1.0, 30.0)] * 5)
        m = 0.5 * hw.levels[0].capacity
        return (new.to_payload(), new.l_atomic(ts[0], m), hw.l_atomic(ts[0], m), new.l_atomic(ts[-1], m),
                hw.l_atomic(ts[-1], m))

    _, narrow, narrow0, wide, wide0 = both(scenario)[0]
    assert narrow == pytest.approx(10.0 * narrow0, rel=0.05)
    assert wide == pytest.approx(30.0 * wide0, rel=0.05)


def _scaled_backend(core, factor=20.0):
    class ScaledBackend:
        """A substrate whose host runs every step at ``factor`` times the
        preset's modeled cost, far outside the clip window."""

        name = "scaled"

        def __init__(self):
            self._inner = core.ModeledBackend()

        def prepare(self, executor, prep):
            return self._inner.prepare(executor, prep)

        def execute(self, plan, step, modeled_ns=0.0):
            return self._inner.execute(plan, step, modeled_ns) * factor

    return ScaledBackend()


def test_recalibrate_flag_refits_engine_preset_when_gate_trips(graphs):
    rep, fb, payload, untouched = _run(graphs, feedback=True, recalibrate=True, backend=_scaled_backend)
    from repro_torch.core import PR_PULL, XEON_E5_2660V4
    from repro_torch.core.contention import HardwareModel

    assert rep.total_edges > 0
    assert not untouched
    hw = HardwareModel.from_payload(payload)
    m = 0.5 * hw.levels[0].capacity
    for t in (1, hw.thread_counts[-1]):
        assert hw.l_atomic(t, m) == pytest.approx(20.0 * XEON_E5_2660V4.l_atomic(t, m), rel=0.25)
    assert not fb.censor_tripped()
    assert fb.recalibration_pairs() == []
    assert fb.width_ratio(PR_PULL.name, 8) == 1.0


def test_recalibrate_off_leaves_preset_alone(graphs):
    _, fb, _, untouched = _run(graphs, feedback=True, backend=_scaled_backend)
    assert untouched
    assert fb.censor_tripped()
    assert fb.recalibration_pairs()
