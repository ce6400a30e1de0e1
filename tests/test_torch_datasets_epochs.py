"""Parity of the port's SNAP surrogates, epoch log and sampler with the JAX
package: the same arguments, batches and seeds give equal arrays, stats,
keys, epochs and sampled blocks; plus the port's own epoch-log invariants
(delta stats equal a from-scratch build, snapshots immutable, snapshots on
the base graph's device) and its oracles against the JAX package's."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.algorithms as jalg  # noqa: E402
import repro.graph as jgraph  # noqa: E402
import repro_torch.algorithms as talg  # noqa: E402
import repro_torch.graph as tgraph  # noqa: E402
from _torch_bench_rows import one_torch_thread, split_stream  # noqa: E402,F401
from _torch_parity import hubs, port_graph  # noqa: E402


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
    assert (jg.name, jg.surrogate, jg.epoch) == (tg.name, tg.surrogate, tg.epoch)


# ---------------- SNAP surrogates ----------------

@pytest.mark.parametrize("name", sorted(jgraph.SNAP_SPECS))
def test_load_dataset_matches_jax(name):
    jg = jgraph.load_dataset(name, scale_div=512)
    tg = tgraph.load_dataset(name, scale_div=512, device="cpu")
    _assert_same_graph(jg, tg)
    assert tg.surrogate


@pytest.mark.parametrize("name", ["roadNet-CA", "soc-LiveJournal1"])
def test_load_dataset_default_scale_matches_jax(name):
    _assert_same_graph(jgraph.load_dataset(name), tgraph.load_dataset(name, device="cpu"))


def test_load_dataset_seed_and_specs_match_jax():
    _assert_same_graph(
        jgraph.load_dataset("as-skitter", scale_div=512, seed=5),
        tgraph.load_dataset("as-skitter", scale_div=512, seed=5, device="cpu"),
    )
    assert tgraph.all_dataset_names() == jgraph.all_dataset_names()
    assert {k: dataclasses.asdict(v) for k, v in tgraph.SNAP_SPECS.items()} == {
        k: dataclasses.asdict(v) for k, v in jgraph.SNAP_SPECS.items()
    }


def test_unknown_dataset_raises_the_same_key_error():
    with pytest.raises(KeyError) as want:
        jgraph.load_dataset("no-such-graph")
    with pytest.raises(KeyError) as got:
        tgraph.load_dataset("no-such-graph", device="cpu")
    assert str(got.value) == str(want.value)


# ---------------- the epoch log ----------------

def _split(graph, scale, seed, base_fraction, n_batches):
    return split_stream(graph, scale, seed=seed, base_fraction=base_fraction, n_batches=n_batches, name="epochs")


def test_epoch_log_publish_sequence_matches_jax():
    """One publish sequence on both packages: ordinary batches, an empty
    batch, a batch of one edge repeated, a batch that repeats earlier edges,
    no-op publishes, and two appends published at once."""
    jbase, batches = _split(jgraph, 9, 7, 0.6, 3)
    tbase, _ = _split(tgraph, 9, 7, 0.6, 3)
    jlog, tlog = jgraph.GraphEpochLog(jbase), tgraph.GraphEpochLog(tbase)
    b0s, b0d = batches[0]
    steps = [
        ("ingest", batches[0]),
        ("ingest", (np.array([], dtype=np.int64), np.array([], dtype=np.int64))),
        ("publish", None),
        ("ingest", (np.full(9, 5), np.full(9, 17))),
        ("ingest", (b0s[:40], b0d[:40])),
        ("append", batches[1]),
        ("append", batches[2]),
        ("publish", None),
        ("publish", None),
    ]
    for op, batch in steps:
        if op == "ingest":
            jg, tg = jlog.ingest(*batch), tlog.ingest(*batch)
        elif op == "append":
            assert tlog.append(*batch) == jlog.append(*batch)
            assert tlog.pending_edges == jlog.pending_edges
            jg, tg = jlog.current(), tlog.current()
        else:
            jg, tg = jlog.publish(), tlog.publish()
        _assert_same_graph(jg, tg)
        assert tlog.epoch == jlog.epoch == tg.epoch
        assert tlog.pending_edges == jlog.pending_edges
    assert tlog.epoch == 4


@pytest.mark.parametrize("seed,n_batches", [(0, 1), (11, 3), (57, 5)])
def test_delta_stats_match_from_scratch(seed, n_batches):
    """Stats delta-updated across publishes equal a from-scratch
    ``build_graph`` over the cumulative edge list, exactly."""
    base, batches = _split(tgraph, 8, seed, 0.65, n_batches)
    src, dst = tgraph.rmat_edges(8, seed=seed)
    n = 2 ** 8
    log = tgraph.GraphEpochLog(base)
    lo = base.num_edges
    for bsrc, bdst in batches:
        g = log.ingest(bsrc, bdst)
        lo += len(bsrc)
        ref = tgraph.build_graph(src[:lo], dst[:lo], n, name="epochs", device="cpu")
        assert g.stats == ref.stats
        assert torch.equal(g.csr.indptr, ref.csr.indptr)
        assert torch.equal(g.csr_in.indptr, ref.csr_in.indptr)
        assert torch.equal(torch.sort(g.csr_in.indices).values, torch.sort(ref.csr_in.indices).values)


def test_append_validates_vertex_range():
    base, _ = _split(tgraph, 7, 3, 0.9, 1)
    log = tgraph.GraphEpochLog(base)
    with pytest.raises(ValueError, match="dst out of range"):
        log.append([0], [base.num_vertices])
    with pytest.raises(ValueError, match="src out of range"):
        log.append([-1], [0])
    with pytest.raises(ValueError, match="equal length"):
        log.append([0, 1], [0])
    assert log.pending_edges == 0 and log.publish() is base


def test_reader_snapshot_tensors_never_change_after_publish():
    base, batches = _split(tgraph, 9, 7, 0.7, 3)
    log = tgraph.GraphEpochLog(base)
    held = log.current()
    views = [held.csr.indptr, held.csr.indices, held.csr_in.indptr, held.csr_in.indices, held.src, held.dst]
    frozen = [t.clone() for t in views]
    stats0, key0 = held.stats, held.key
    for bsrc, bdst in batches:
        g = log.ingest(bsrc, bdst)
        assert g.src.data_ptr() not in {t.data_ptr() for t in views}
    assert log.epoch == 3
    assert all(torch.equal(a, b) for a, b in zip(views, frozen))
    assert held.stats == stats0 and held.key == key0


def test_snapshots_stay_on_the_base_graph_device(monkeypatch):
    """A log over a CPU graph publishes CPU snapshots even where a card
    would be the default device."""
    base, batches = _split(tgraph, 7, 3, 0.8, 2)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    log = tgraph.GraphEpochLog(base)
    for b in batches:
        g = log.ingest(*b)
        tensors = (g.csr.indptr, g.csr.indices, g.csr_in.indptr, g.csr_in.indices, g.src, g.dst)
        assert all(t.device.type == "cpu" and t.dtype == torch.int32 for t in tensors)


# ---------------- the sampler ----------------

def test_degree_stat_tracker_matches_jax():
    src = np.array([0, 1, 2, 2])
    dst = np.array([1, 2, 3, 3])
    jt = jgraph.DegreeStatTracker(jgraph.build_graph(src, dst, 5, name="dups"))
    tt = tgraph.DegreeStatTracker(tgraph.build_graph(src, dst, 5, name="dups", device="cpu"))
    rng = np.random.default_rng(4)
    for batch in ([[2, 2, 4], [3, 3, 0]], [[], []], rng.integers(0, 5, size=(2, 30))):
        jt.add(np.asarray(batch[0]), np.asarray(batch[1]))
        tt.add(np.asarray(batch[0]), np.asarray(batch[1]))
        assert dataclasses.asdict(tt.stats()) == dataclasses.asdict(jt.stats())
    ref = tgraph.build_graph(
        np.concatenate([src, [2, 2, 4], batch[0]]), np.concatenate([dst, [3, 3, 0], batch[1]]), 5, device="cpu"
    )
    assert tt.stats() == ref.stats


@pytest.fixture(scope="module")
def sample_graphs():
    jg = jgraph.rmat_graph(10, seed=3)
    return jg, port_graph(jg)


@pytest.mark.parametrize("fanouts", [(15, 10), (5,), (3, 3, 2), (0, 4)])
@pytest.mark.parametrize("seed", [0, 1, 29])
def test_sample_fanout_matches_jax(sample_graphs, fanouts, seed):
    jg, tg = sample_graphs
    seeds = np.random.default_rng(seed).choice(jg.num_vertices, size=8, replace=False)
    want = jgraph.sample_fanout(jg, seeds, fanouts, seed=seed)
    got = tgraph.sample_fanout(tg, seeds, fanouts, seed=seed)
    for f in dataclasses.fields(want):
        a, b = getattr(want, f.name), getattr(got, f.name)
        if isinstance(a, np.ndarray):
            assert b.dtype == a.dtype
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b
    assert tgraph.plan_capacity(len(seeds), fanouts) == jgraph.plan_capacity(len(seeds), fanouts)
    assert (got.max_nodes, got.max_edges) == tgraph.plan_capacity(len(seeds), fanouts)


def test_block_to_device_matches_jax(sample_graphs):
    jg, tg = sample_graphs
    block = tgraph.sample_fanout(tg, np.array([3, 77, 500]), (6, 4), seed=2)
    want = jgraph.block_to_device(block)
    got = tgraph.block_to_device(block, device="cpu")
    assert sorted(got) == sorted(want)
    for k, a in want.items():
        t = got[k]
        assert t.device.type == "cpu"
        assert t.dtype == (torch.bool if "mask" in k else torch.int32)
        np.testing.assert_array_equal(np.asarray(a), t.numpy())


def test_block_to_device_refuses_cpu_without_explicit_device(monkeypatch):
    block = tgraph.SampledBlock(
        nodes=np.array([0, -1], dtype=np.int32), num_nodes=1, src=np.array([-1], dtype=np.int32),
        dst=np.array([-1], dtype=np.int32), num_edges=0, seeds=np.array([0], dtype=np.int32),
    )
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgraph.block_to_device(block)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tgraph.load_dataset("roadNet-PA", scale_div=512)


# ---------------- the oracles ----------------

@pytest.mark.parametrize("name", ["roadNet-CA", "soc-LiveJournal1"])
def test_oracles_match_jax(name):
    """The port's BFS oracle (frontier-gathering over the out-CSR) gives the
    JAX package's levels, with and without a level limit; its PageRank
    oracle (a weighted bincount) the JAX package's ranks, in float64; its
    degree-count oracle (two bincounts) the JAX package's counts."""
    jg = jgraph.load_dataset(name, scale_div=512)
    tg = port_graph(jg)
    for src in hubs(tg.out_degrees())[:3]:
        np.testing.assert_array_equal(talg.bfs_reference(tg, int(src)), jalg.bfs_reference(jg, int(src)))
        np.testing.assert_array_equal(
            talg.bfs_reference(tg, int(src), max_iters=2), jalg.bfs_reference(jg, int(src), max_iters=2)
        )
    np.testing.assert_allclose(talg.pagerank_reference(tg, iters=7), jalg.pagerank_reference(jg, iters=7), rtol=1e-12)
    src, dst = np.asarray(jg.src), np.asarray(jg.dst)
    for c in (jg.num_vertices, 1000, 7):
        got = talg.degree_count_reference(src, dst, c)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, jalg.degree_count_reference(src, dst, c))
