"""The port's ``graph/partition.py`` against the JAX package's, test for
test with ``tests/test_partition.py``: the same ranges, heavy-first orders
and ``GraphPartition``s (bounds, shards with their rebased CSR views and
cut statistics, degree mass) on the same graphs, each built by both
packages' own builders, and the reference's edge-case assertions held on
the port."""
import numpy as np
import pytest

pytest.importorskip("torch")

import repro.graph as jgraph  # noqa: E402
import repro.graph.partition as jpart  # noqa: E402
import repro_torch.graph as tgraph  # noqa: E402
import repro_torch.graph.partition as tpart  # noqa: E402
from _torch_parity import plain  # noqa: E402
from _torch_bench_rows import one_torch_thread  # noqa: E402,F401  (autouse: one torch thread a test)


def hub_graph(g, n=16, fan=64, **kw):
    src = np.zeros(fan, dtype=np.int64)
    dst = np.arange(fan, dtype=np.int64) % n
    return g.build_graph(src, dst, n, name="hub", **kw)


def edgeless_graph(g, n=8, **kw):
    return g.build_graph(np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64), n, name="empty", **kw)


CPU = {"device": "cpu"}


def partition(make, domains):
    """``partition_graph`` of the graph ``make(graph_module, **kw)`` builds,
    in both packages; the partitions must be equal field for field."""
    got = tpart.partition_graph(make(tgraph, **CPU), domains)
    want = jpart.partition_graph(make(jgraph), domains)
    assert plain(got) == plain(want)
    return got


def ranges(degrees, parts):
    got = tpart.degree_balanced_ranges(degrees, parts)
    assert plain(got) == plain(jpart.degree_balanced_ranges(degrees, parts))
    return got


def test_zero_degree_falls_back_to_equal_ranges():
    bounds = ranges(np.zeros(10, dtype=np.int64), 4)
    assert np.array_equal(bounds, tpart.equal_ranges(10, 4))
    assert plain(tpart.equal_ranges(10, 4)) == plain(jpart.equal_ranges(10, 4))
    assert bounds[0] == 0 and bounds[-1] == 10


def test_parts_exceeding_vertices_yield_empty_ranges():
    bounds = ranges(np.ones(3, dtype=np.int64), 8)
    assert len(bounds) == 9
    assert bounds[0] == 0 and bounds[-1] == 3
    assert np.all(np.diff(bounds) >= 0)
    assert np.diff(bounds).sum() == 3


def test_heavy_vertex_produces_duplicate_bounds():
    bounds = ranges(np.array([100, 0, 0, 0], dtype=np.int64), 4)
    assert bounds[0] == 0 and bounds[-1] == 4
    assert np.all(np.diff(bounds) >= 0)
    assert np.any(np.diff(bounds) == 0)


def test_bounds_monotone_on_random_degrees():
    rng = np.random.default_rng(0)
    for parts in (1, 2, 3, 7, 16, 40):
        degrees = rng.integers(0, 50, size=33)
        bounds = ranges(degrees, parts)
        assert len(bounds) == parts + 1
        assert bounds[0] == 0 and bounds[-1] == 33
        assert np.all(np.diff(bounds) >= 0)
    for n, k in ((100, 7), (5, 9), (0, 3)):
        assert plain(tpart.edge_shards(n, k)) == plain(jpart.edge_shards(n, k))
        assert plain(tpart.vertex_shards(n, k)) == plain(jpart.vertex_shards(n, k))


def test_heavy_first_order_masks_empty_packages():
    degrees = np.array([100, 1, 1, 1], dtype=np.int64)
    bounds = ranges(degrees, 4)
    assert np.any(np.diff(bounds) == 0)
    order = tpart.heavy_first_order(degrees, bounds)
    assert plain(order) == plain(jpart.heavy_first_order(degrees, bounds))
    widths = np.diff(bounds)
    assert widths[order[0]] > 0
    n_nonempty = int((widths > 0).sum())
    assert all(widths[p] > 0 for p in order[:n_nonempty])
    assert all(widths[p] == 0 for p in order[n_nonempty:])


def test_heavy_first_order_orders_by_work():
    degrees = np.array([1, 1, 50, 1, 1, 1], dtype=np.int64)
    bounds = np.array([0, 2, 3, 6], dtype=np.int64)
    order = tpart.heavy_first_order(degrees, bounds)
    assert plain(order) == plain(jpart.heavy_first_order(degrees, bounds))
    assert order[0] == 1


def test_partition_rejects_bad_domain_count():
    with pytest.raises(ValueError) as got:
        tpart.GraphPartition.build(hub_graph(tgraph, **CPU), 0)
    with pytest.raises(ValueError) as want:
        jpart.GraphPartition.build(hub_graph(jgraph), 0)
    assert str(got.value) == str(want.value)


def test_partition_edgeless_graph():
    part = partition(edgeless_graph, 4)
    assert part.num_domains == 4
    assert part.num_vertices == 8
    assert np.all(part.degree_mass == 0)
    for shard in part.shards:
        assert shard.num_edges == 0
        assert shard.cut_edges == 0 and shard.halo == 0
        assert shard.cut_fraction == 0.0
        assert shard.indptr[0] == 0
    assert part.dominant_domain() == 0


def test_partition_more_domains_than_vertices():
    def two(g, **kw):
        return g.build_graph(np.array([0, 1], dtype=np.int64), np.array([1, 0], dtype=np.int64), 2, **kw)

    part = partition(two, 5)
    assert part.num_domains == 5
    assert np.all(np.diff(part.bounds) >= 0)
    assert sum(s.num_vertices for s in part.shards) == 2
    assert sum(s.num_edges for s in part.shards) == 2
    for v in range(2):
        d = part.shard_of(v)
        assert part.shards[d].v_lo <= v < part.shards[d].v_hi


def test_partition_hub_graph_duplicate_bounds():
    part = partition(hub_graph, 4)
    widths = np.diff(part.bounds)
    assert np.any(widths == 0)
    for d, shard in enumerate(part.shards):
        if shard.num_vertices == 0:
            assert part.degree_mass[d] == 0
    assert part.degree_mass.sum() == 64
    assert part.dominant_domain() == int(np.argmax(part.degree_mass))


def test_shard_boundaries_partition_the_vertex_range():
    def make(g, **kw):
        return g.clustered_graph(6, 4, edge_factor=4, seed=1, cross_fraction=0.02, **kw)

    part = partition(make, 4)
    assert part.bounds[0] == 0
    assert part.bounds[-1] == part.num_vertices
    assert np.all(np.diff(part.bounds) >= 0)
    for d in range(1, part.num_domains):
        assert part.shards[d].v_lo == part.shards[d - 1].v_hi
    for d, shard in enumerate(part.shards):
        assert shard.indptr[0] == 0
        assert shard.indptr[-1] == shard.num_edges
        assert np.all(np.diff(shard.indptr) >= 0)
        assert part.degree_mass[d] == shard.num_edges
        assert shard.internal_edges + shard.cut_edges == shard.num_edges
        assert shard.halo <= shard.cut_edges


def test_shard_of_bounds_checked():
    part = partition(hub_graph, 2)
    jp = jpart.partition_graph(hub_graph(jgraph), 2)
    for v in (-1, part.num_vertices):
        with pytest.raises(ValueError) as got:
            part.shard_of(v)
        with pytest.raises(ValueError) as want:
            jp.shard_of(v)
        assert str(got.value) == str(want.value)
    assert [part.shard_of(v) for v in range(16)] == [jp.shard_of(v) for v in range(16)]


def test_domain_mass_empty_and_weighted_frontiers():
    def make(g, **kw):
        return g.clustered_graph(5, 4, edge_factor=4, seed=2, **kw)

    part = partition(make, 4)
    jp = jpart.partition_graph(make(jgraph), 4)
    empty = np.empty(0, dtype=np.int64)
    assert np.all(part.domain_mass(empty) == 0.0)
    block = 1 << 5
    frontier = np.arange(3, dtype=np.int64) + 2 * block
    mass = part.domain_mass(frontier)
    weighted = part.domain_mass(frontier, degrees=np.array([5.0, 1.0, 2.0]))
    assert plain((part.domain_mass(empty), mass, weighted, part.domain_mass(None))) == plain(
        (jp.domain_mass(empty), jp.domain_mass(frontier), jp.domain_mass(frontier, degrees=np.array([5.0, 1.0, 2.0])),
         jp.domain_mass(None)))
    assert mass.sum() == 3
    assert weighted.sum() == 8.0
    assert part.dominant_domain(frontier) == int(np.argmax(mass)) == jp.dominant_domain(frontier)


def test_clustered_graph_partition_recovers_communities():
    def make(g, **kw):
        return g.clustered_graph(6, 4, edge_factor=4, seed=3, cross_fraction=0.0, **kw)

    part = partition(make, 4)
    block = 1 << 6
    for k in range(4):
        seed_frontier = np.array([k * block + 1], dtype=np.int64)
        assert part.dominant_domain(seed_frontier) == part.shard_of(k * block + 1)
    assert sum(s.cut_edges for s in part.shards) <= sum(s.num_edges for s in part.shards) * 0.05
