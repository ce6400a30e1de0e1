"""Parity of the port's graph construction with the JAX package: the same
generator arguments give equal CSR arrays, statistics, keys and partitions."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.graph as jgraph  # noqa: E402
import repro_torch.graph as tgraph  # noqa: E402
from _torch_parity import port_graph  # noqa: E402

BUILDERS = {
    "rmat": lambda m, **kw: m.rmat_graph(10, seed=3, **kw),
    "uniform": lambda m, **kw: m.uniform_random_graph(700, 5000, seed=5, **kw),
    "grid": lambda m, **kw: m.grid_graph(13, **kw),
    "clustered": lambda m, **kw: m.clustered_graph(7, 3, seed=2, **kw),
}


def _assert_same_graph(jg, tg):
    pairs = [
        (jg.csr.indptr, tg.csr.indptr),
        (jg.csr.indices, tg.csr.indices),
        (jg.csr_in.indptr, tg.csr_in.indptr),
        (jg.csr_in.indices, tg.csr_in.indices),
        (jg.src, tg.src),
        (jg.dst, tg.dst),
    ]
    for a, b in pairs:
        assert b.dtype == torch.int32 and b.device.type == "cpu"
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert dataclasses.asdict(jg.stats) == dataclasses.asdict(tg.stats)
    assert jg.key == tg.key
    assert all(type(x) is type(y) for x, y in zip(jg.key, tg.key))
    assert (jg.num_vertices, jg.num_edges) == (tg.num_vertices, tg.num_edges)
    np.testing.assert_array_equal(np.asarray(jg.out_degrees()), tg.out_degrees().numpy())
    np.testing.assert_array_equal(np.asarray(jg.in_degrees()), tg.in_degrees().numpy())
    np.testing.assert_array_equal(
        np.asarray(jg.csr_in.edge_sources()), tg.csr_in.edge_sources().numpy()
    )


@pytest.mark.parametrize("kind", sorted(BUILDERS))
def test_builders_match_jax(kind):
    build = BUILDERS[kind]
    _assert_same_graph(build(jgraph), build(tgraph, device="cpu"))


def test_graph_from_arrays_matches_jax():
    jg = jgraph.rmat_graph(10, seed=3)
    _assert_same_graph(jg, port_graph(jg))


def test_build_graph_dedup_matches_jax():
    rng = np.random.default_rng(11)
    src = rng.integers(0, 64, size=900)
    dst = rng.integers(0, 64, size=900)
    jg = jgraph.build_graph(src, dst, 64, name="dup", dedup=True)
    tg = tgraph.build_graph(src, dst, 64, name="dup", dedup=True, device="cpu")
    _assert_same_graph(jg, tg)


def test_build_graph_rejects_bad_edges():
    with pytest.raises(ValueError, match="out of range"):
        tgraph.build_graph([0, 5], [1, 2], 4, device="cpu")
    with pytest.raises(ValueError, match="equal length"):
        tgraph.build_graph([0, 1], [1], 4, device="cpu")


@pytest.mark.parametrize("domains", [1, 2, 4])
def test_partition_matches_jax(domains):
    jg = jgraph.clustered_graph(7, 3, seed=2)
    tg = port_graph(jg)
    jp = jgraph.partition_graph(jg, domains)
    tp = tgraph.partition_graph(tg, domains)
    np.testing.assert_array_equal(jp.bounds, tp.bounds)
    np.testing.assert_array_equal(jp.degree_mass, tp.degree_mass)
    assert jp.graph_key == tp.graph_key
    for a, b in zip(jp.shards, tp.shards):
        assert (a.v_lo, a.v_hi, a.internal_edges, a.cut_edges, a.halo) == (
            b.v_lo, b.v_hi, b.internal_edges, b.cut_edges, b.halo
        )
        np.testing.assert_array_equal(a.indptr, b.indptr)


def test_pad_edges_matches_jax():
    import jax.numpy as jnp

    s = np.arange(10, dtype=np.int32)
    d = s[::-1].copy()
    js, jd, je = jgraph.pad_edges(jnp.asarray(s), jnp.asarray(d), 8, -1)
    ts, td, te = tgraph.pad_edges(torch.from_numpy(s), torch.from_numpy(d), 8, -1)
    assert je == te == 10
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    np.testing.assert_array_equal(np.asarray(jd), td.numpy())
