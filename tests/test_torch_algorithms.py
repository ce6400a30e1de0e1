"""The port's query executors against the JAX package's on the same graph:
BFS levels and degree counts exactly, PageRank within the reference
tolerance with the same iteration count, and the same query records."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import repro.algorithms as jalg  # noqa: E402
import repro.core as jcore  # noqa: E402
import repro_torch.algorithms as talg  # noqa: E402
import repro_torch.core as tcore  # noqa: E402
from repro.graph import rmat_graph  # noqa: E402
from _torch_parity import hubs, port_graph, record_fields  # noqa: E402

PR_RTOL, PR_ATOL = 2e-4, 1e-8  # the JAX package's own PageRank tolerance


@pytest.fixture(scope="module")
def graphs():
    jg = rmat_graph(10, seed=3)
    return jg, port_graph(jg)


def _run(core, ex, policy="scheduler"):
    eng = core.MultiQueryEngine(core.XEON_E5_2660V4, policy=policy)
    rec = core.QueryRecord(0, 0, ex.desc.name)
    eng.run_query(ex, rec)
    return rec


def _same_record(jrec, trec):
    assert record_fields(jrec) == record_fields(trec)


@pytest.mark.parametrize("rank", [0, 1, 5, 300])
def test_bfs_levels_match_jax(graphs, rank):
    jg, tg = graphs
    src = int(hubs(np.asarray(jg.out_degrees()))[rank])
    jex, tex = jalg.BFSExecutor(jg, src), talg.BFSExecutor(tg, src)
    jrec, trec = _run(jcore, jex), _run(tcore, tex)
    assert tex.result().dtype == np.int32
    np.testing.assert_array_equal(tex.result(), jex.result())
    np.testing.assert_array_equal(tex.result(), talg.bfs_reference(tg, src))
    _same_record(jrec, trec)


def test_direction_optimized_bfs_matches_jax(graphs):
    jg, tg = graphs
    src = int(hubs(np.asarray(jg.out_degrees()))[0])
    jex = jalg.DirectionOptimizedBFSExecutor(jg, src)
    tex = talg.DirectionOptimizedBFSExecutor(tg, src)
    jrec, trec = _run(jcore, jex), _run(tcore, tex)
    np.testing.assert_array_equal(tex.result(), jex.result())
    _same_record(jrec, trec)


@pytest.mark.parametrize("num_counters", [None, 1000])
def test_degree_count_matches_jax(graphs, num_counters):
    jg, tg = graphs
    jex = jalg.DegreeCountExecutor(jg, num_counters=num_counters)
    tex = talg.DegreeCountExecutor(tg, num_counters=num_counters)
    jrec, trec = _run(jcore, jex), _run(tcore, tex)
    np.testing.assert_array_equal(tex.result(), jex.result())
    assert tex.result().dtype == np.int32
    _same_record(jrec, trec)


@pytest.mark.parametrize(
    "mode,max_iters,tol", [("pull", 5, 0.0), ("push", 5, 0.0), ("pull", 60, 1e-6), ("push", 60, 1e-6)]
)
def test_pagerank_matches_jax(graphs, mode, max_iters, tol):
    jg, tg = graphs
    jex = jalg.PageRankExecutor(jg, mode=mode, max_iters=max_iters, tol=tol)
    tex = talg.PageRankExecutor(tg, mode=mode, max_iters=max_iters, tol=tol)
    jrec, trec = _run(jcore, jex), _run(tcore, tex)
    assert tex._iter == jex._iter  # convergence is not moved by f32 sum order
    np.testing.assert_allclose(tex.result(), jex.result(), rtol=PR_RTOL, atol=PR_ATOL)
    np.testing.assert_allclose(
        tex.result(), talg.pagerank_reference(tg, iters=tex._iter), rtol=PR_RTOL, atol=PR_ATOL
    )
    _same_record(jrec, trec)


def test_compact_frontier_matches_jax():
    rng = np.random.default_rng(4)
    for p in (0.0, 0.01, 0.3, 1.0):
        mask = rng.random(777) < p
        jl, jn = jalg.compact_frontier(jnp.asarray(mask))
        tl, tn = talg.compact_frontier(torch.from_numpy(mask))
        assert tl.dtype == torch.int32 and int(tn) == int(jn)
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


def test_member_mask_matches_jax():
    rng = np.random.default_rng(5)
    mask = rng.random(300) < 0.2
    jl, jn = jalg.compact_frontier(jnp.asarray(mask))
    tl, tn = talg.compact_frontier(torch.from_numpy(mask))
    for lo, hi in [(0, 5), (3, 40), (10, 10_000), (50, 40)]:
        want = jalg.member_mask_from_slots(jl, jn, jnp.int32(lo), jnp.int32(hi), 300)
        got = talg.member_mask_from_slots(tl, int(tn), lo, hi, 300)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_edge_arrays_match_jax(graphs):
    jg, tg = graphs
    je, te = jalg.EdgeArrays.from_graph(jg), talg.EdgeArrays.from_graph(tg)
    for f in ("src", "dst", "in_src", "in_dst", "out_deg"):
        np.testing.assert_array_equal(getattr(te, f).numpy(), np.asarray(getattr(je, f)))
    assert (te.num_vertices, te.num_edges) == (je.num_vertices, je.num_edges)
