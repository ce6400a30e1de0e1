"""The port's Eq. 1–6 traversal estimators (``repro_torch.core.estimators``)
against the JAX package's, test for test with ``tests/test_estimators.py``:
each estimate equal to the reference's on the same inputs, and the
reference's bounds, monotonicity and Monte-Carlo agreement held on the
port."""
import math

import numpy as np
import pytest
from _hypothesis_compat import given, settings, st

pytest.importorskip("torch")

from repro.core import estimators as jest  # noqa: E402
from repro_torch.core import estimators as pest  # noqa: E402
from _torch_bench_rows import one_torch_thread  # noqa: E402,F401  (autouse: one torch thread a test)


@given(frontier=st.integers(0, 10_000), deg=st.floats(0.0, 64.0), v_reach=st.integers(1, 1_000_000))
@settings(max_examples=200, deadline=None)
def test_touched_bounds(frontier, deg, v_reach):
    u = pest.estimate_touched_closed_form(frontier, deg, v_reach)
    assert u == jest.estimate_touched_closed_form(frontier, deg, v_reach)
    assert 0.0 <= u <= v_reach + 1e-6


@given(deg=st.floats(0.01, 32.0), v_reach=st.integers(10, 100_000))
@settings(max_examples=100, deadline=None)
def test_touched_monotone_in_frontier(deg, v_reach):
    prev = -1.0
    for s in (0, 1, 10, 100, 1000, 10_000):
        u = pest.estimate_touched_closed_form(s, deg, v_reach)
        assert u == jest.estimate_touched_closed_form(s, deg, v_reach)
        assert u >= prev - 1e-9
        prev = u


@given(frontier=st.integers(0, 5000), deg=st.floats(0.0, 16.0), v_reach=st.integers(1, 100_000),
       unvisited_frac=st.floats(0.0, 1.0))
@settings(max_examples=200, deadline=None)
def test_found_bounded_by_unvisited(frontier, deg, v_reach, unvisited_frac):
    unvisited = v_reach * unvisited_frac
    f = pest.estimate_found_closed_form(frontier, deg, v_reach, unvisited)
    assert f == jest.estimate_found_closed_form(frontier, deg, v_reach, unvisited)
    assert 0.0 <= f <= unvisited + 1e-6
    u = pest.estimate_touched_closed_form(frontier, deg, v_reach)
    assert f <= u + 1e-6


def test_found_paper_form_overcounts():
    v_reach, unvisited = 10_000, 100.0
    paper = pest.estimate_found_paper_form(5_000, 8.0, v_reach, unvisited)
    ours = pest.estimate_found_closed_form(5_000, 8.0, v_reach, unvisited)
    assert paper == jest.estimate_found_paper_form(5_000, 8.0, v_reach, unvisited)
    assert ours == jest.estimate_found_closed_form(5_000, 8.0, v_reach, unvisited)
    assert ours <= unvisited + 1e-6
    assert paper > unvisited  # the overcount


def test_sampled_matches_exact_on_uniform_degrees():
    degs = np.full(500, 7.0)
    v_reach = 10_000
    exact = pest.estimate_touched_exact(degs, v_reach)
    closed = pest.estimate_touched_closed_form(500, 7.0, v_reach)
    sampled = pest.estimate_touched_sampled(degs[:100], 500, v_reach)
    assert (exact, closed, sampled) == (jest.estimate_touched_exact(degs, v_reach),
                                        jest.estimate_touched_closed_form(500, 7.0, v_reach),
                                        jest.estimate_touched_sampled(degs[:100], 500, v_reach))
    assert math.isclose(exact, closed, rel_tol=1e-9)
    assert math.isclose(sampled, exact, rel_tol=1e-6)


def test_against_monte_carlo():
    rng = np.random.default_rng(0)
    v_reach, frontier, deg = 2_000, 60, 5
    hits = []
    for _ in range(200):
        touched = set()
        for _ in range(frontier):
            touched.update(rng.integers(0, v_reach, deg))
        hits.append(len(touched))
    mc = float(np.mean(hits))
    est = pest.estimate_touched_closed_form(frontier, deg, v_reach)
    assert est == jest.estimate_touched_closed_form(frontier, deg, v_reach)
    assert abs(est - mc) / mc < 0.05


def test_variance_gate():
    out = {}
    for name, mod in (("jax", jest), ("torch", pest)):
        est_low = mod.TraversalEstimator(deg_mean=10, deg_max=10.5, v_reach=1000)
        est_high = mod.TraversalEstimator(deg_mean=10, deg_max=500, v_reach=1000)
        assert est_low.low_variance and not est_high.low_variance
        skewed = np.array([500] + [1] * 99)
        u = est_high.touched(100, frontier_degrees=skewed)
        assert 0 < u <= 1000
        out[name] = (u, est_low.touched(100, frontier_degrees=skewed),
                     est_high.found(100, 400.0, frontier_degrees=skewed), est_low.found(100, 400.0))
    assert out["torch"] == out["jax"]
