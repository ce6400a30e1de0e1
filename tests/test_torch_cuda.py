"""The port's CUDA kernels on the card: each against its plain PyTorch
version, and the ``cuda`` backend end to end. Every test here needs a CUDA
device and skips without one; the file imports no JAX, so it runs where
only PyTorch is installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_gnn import CARD_CASES, card_equals_cpu  # noqa: E402
from _torch_recsys import card_equals_cpu as recsys_card_equals_cpu  # noqa: E402
from repro_torch import algorithms as alg  # noqa: E402
from repro_torch import core  # noqa: E402
from repro_torch.graph import rmat_graph  # noqa: E402
from repro_torch.kernels.attention import flash_attention_cuda, flash_attention_plain  # noqa: E402
from repro_torch.kernels.degree_count import degree_count_cuda, degree_count_plain  # noqa: E402
from repro_torch.kernels.degree_count.degree_count import (  # noqa: E402
    PRIVATE_MIN_IDS,
    _degree_count_path,
    _degree_count_variant,
    _lib as _degree_count_lib,
)
from repro_torch.kernels.embedding_bag import (  # noqa: E402
    EmbeddingBagFunction,
    embedding_bag_cuda,
    embedding_bag_plain,
)
from repro_torch.kernels.scoring import scoring_cuda, scoring_plain  # noqa: E402
from repro_torch.kernels.scoring.scoring import (  # noqa: E402
    STREAM_MAX_BATCH,
    _lib,
    _scoring_path,
    _scoring_variant,
)
from repro_torch.kernels.spmv import (  # noqa: E402
    BLOCK_EDGES,
    build_tiles,
    spmv_rows_cuda,
    spmv_rows_plain,
    spmv_tiles,
)
from repro_torch.layers import embedding as layers  # noqa: E402
from repro_torch.layers import moe  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.recsys import FieldSpec, TwoTower, TwoTowerConfig  # noqa: E402

pytestmark = pytest.mark.cuda

# f32 sums of the same positive terms in another order (warp tree vs the
# plain version's atomic adds, whose order changes from run to run): the
# relative error grows like sqrt(row length) times float32 epsilon, ~1e-5
# for the ~21k-edge hub row below, so 1e-4 (as in chip_smoke.py)
SPMV_RTOL, SPMV_ATOL = 1e-4, 1e-6
# float32 dot products of D <= 256 terms of unit-norm rows (as the towers
# emit them) summed in another order (exact FMAs, or the 3xTF32 split whose
# dropped terms cost ~2^-22 of |a||b| each, vs the library's float32
# product without TF32): errors of a few float32 epsilons times sqrt(D),
# well inside the JAX package's scoring tolerance
SCORE_RTOL = SCORE_ATOL = 1e-5
# flash attention, float32: the JAX package's tolerance (tests/test_kernels.py)
FLASH_TOL = 2e-5
# bf16 outputs of the same float32 math summed in another order: the two
# roundings to bf16 may land one step apart, so torch.testing's bf16 defaults
FLASH_BF16_RTOL, FLASH_BF16_ATOL = 1.6e-2, 1e-5
# fp16 outputs likewise: one fp16 step (2**-10 relative), as the
# long-sequence test has held them
FLASH_F16_TOL = 1e-3


def _unit_rows(shape, g, dev):
    x = torch.randn(*shape, device=dev, generator=g)
    return x / x.norm(dim=-1, keepdim=True)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain products in full float32
    return torch.device("cuda")


def _edges(v, e, seed, targets):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, v, size=e).astype(np.int32)
    dst = rng.choice(np.asarray(targets), size=e).astype(np.int32)
    return src, dst, rng.random(v).astype(np.float32)


def test_spmv_kernel_matches_plain(cuda):
    # two hub rows past BLOCK_EDGES (~21k and ~5.3k edges) are cut into
    # pieces that the last of their CTAs adds up, the rest go in row blocks
    src, dst, contrib = _edges(5000, 80000, 11, np.r_[0:5000, [17] * 2000, [4000] * 500])
    tables = build_tiles(torch.from_numpy(src).to(cuda), torch.from_numpy(dst).to(cuda), 5000)
    pieces = tables.blocks[0][tables.blocks[1] >= 0].cpu()
    assert sorted(set(pieces.tolist())) == [17, 4000] and pieces.numel() > 2
    c = torch.from_numpy(contrib).to(cuda)
    for a, b in [(0, tables.n_tiles), (3, 7), (9, 10), (0, 1), (7, 8)]:
        before = spmv_rows_cuda.launches
        got = spmv_tiles(tables, c, a, b)
        again = spmv_tiles(tables, c, a, b)
        assert spmv_rows_cuda.launches == before + 2
        r0, r1 = a * 512, b * 512
        want = spmv_rows_plain(tables.row_ptr[r0 : r1 + 1], tables.src, c).reshape(b - a, 512)
        torch.testing.assert_close(got, want, rtol=SPMV_RTOL, atol=SPMV_ATOL)
        assert torch.equal(got, again)  # no float atomics: bit-repeatable
    assert not tables.scratch[1].any()  # every long row's counter is back at 0


@pytest.mark.parametrize("hub", [BLOCK_EDGES + 1, 3 * BLOCK_EDGES, 70000])
def test_spmv_hub_rows_above_block_edges(cuda, hub):
    """A row just past BLOCK_EDGES (two pieces, the second of one edge), an
    exact multiple, and one as long as RMAT sf20's largest, beside rows of
    every length up to BLOCK_EDGES; a range that starts and ends inside the
    table, on the full tables and on a slab, same bits twice."""
    rng = np.random.default_rng(hub)
    lens = np.r_[rng.integers(0, 40, 3000), [hub, BLOCK_EDGES, BLOCK_EDGES // 2 + 1, 33, 32, 0]]
    targets = np.repeat(rng.permutation(lens.shape[0]), lens)
    v = lens.shape[0]
    src = rng.integers(0, v, targets.shape[0]).astype(np.int32)
    tables = build_tiles(torch.from_numpy(src).to(cuda), torch.from_numpy(targets.astype(np.int32)).to(cuda), v)
    c = torch.from_numpy(rng.random(v).astype(np.float32)).to(cuda)
    t = tables.n_tiles
    full = spmv_tiles(tables, c, 0, t)
    for a, b in [(0, t), (1, t - 1), (2, 3)]:
        got, again = spmv_tiles(tables, c, a, b), spmv_tiles(tables, c, a, b)
        want = spmv_rows_plain(tables.row_ptr[a * 512 : b * 512 + 1], tables.src, c).reshape(b - a, 512)
        torch.testing.assert_close(got, want, rtol=SPMV_RTOL, atol=SPMV_ATOL)
        assert torch.equal(got, again) and torch.equal(got.reshape(-1), full.reshape(-1)[a * 512 : b * 512])
        slab = tables.slab(a, b)
        assert torch.equal(spmv_tiles(slab, c, 0, b - a), got)
    counts = spmv_tiles(tables, torch.ones(v, device=cuda), 0, t).reshape(-1)[:v]
    assert torch.equal(counts.cpu(), torch.from_numpy(np.bincount(targets, minlength=v).astype(np.float32)))


def test_spmv_slab_on_card(cuda):
    src, dst, contrib = _edges(3000, 40000, 13, np.r_[0:3000, [2100] * 900])
    tables = build_tiles(torch.from_numpy(src).to(cuda), torch.from_numpy(dst).to(cuda), 3000)
    c = torch.from_numpy(contrib).to(cuda)
    slab = tables.slab(2, 6)
    pieces = slab.blocks[0][slab.blocks[1] >= 0].tolist()
    n = int(np.count_nonzero(dst == 2100))  # a ~9k-edge hub row, in pieces
    assert pieces == [2100 - 2 * 512] * -(-n // BLOCK_EDGES)
    assert torch.equal(spmv_tiles(slab, c, 0, 4), spmv_tiles(tables, c, 2, 6))


def test_degree_count_kernel_matches_plain(cuda):
    rng = np.random.default_rng(12)
    table = torch.from_numpy(rng.integers(-1, 70000, size=(2, 200000)).astype(np.int32)).to(cuda)
    for c in (65536, 60001):
        before = degree_count_cuda.launches
        got = degree_count_cuda(table[:, 1000:150000], torch.zeros(c, dtype=torch.int32, device=cuda))
        assert degree_count_cuda.launches == before + 1
        want = degree_count_plain(table[:, 1000:150000], torch.zeros(c, dtype=torch.int32, device=cuda))
        assert torch.equal(got, want)


# the wrapper's own choice, then each kernel forced, on its own grid and on
# a grid cut short (so warps loop over steps and a block's table meets
# more ids)
DEGREE_COUNT_KERNELS = [None, ("runs", 0), ("runs", 3), ("private", 0), ("private", 2)]


def _count(ids, c, kernel, dev):
    counts = torch.zeros(c, dtype=torch.int32, device=dev)
    before = degree_count_cuda.launches
    if kernel is None:
        degree_count_cuda(ids, counts)
    else:
        _degree_count_variant(ids, counts, *kernel)
    assert degree_count_cuda.launches == before + (ids.numel() > 0)  # one launch a call
    want = degree_count_plain(ids, torch.zeros(c, dtype=torch.int32, device=dev))
    assert torch.equal(counts, want)


def _sorted_table(dev, e=60000, v=5000, seed=21):
    """[2, e] endpoint ids: src sorted with RMAT-like runs (a 16 Ki-edge
    package of one id among them), dst unsorted and skewed."""
    rng = np.random.default_rng(seed)
    runs = rng.zipf(1.6, size=e).clip(1, 3000)
    src = np.repeat(rng.integers(0, v, runs.shape[0]), runs)[:e]
    src[20000:20000 + 16384] = 123
    src = np.sort(src)
    dst = (rng.zipf(1.4, size=e).clip(1, 10**6) * 7919) % v
    return torch.from_numpy(np.stack([src, dst]).astype(np.int32)).to(dev)


@pytest.mark.parametrize("kernel", DEGREE_COUNT_KERNELS)
def test_degree_count_one_id_repeated(cuda, kernel):
    for n in (100_000, 16384, 1, 255, 257):
        _count(torch.full((n,), 7, dtype=torch.int32, device=cuda), 10, kernel, cuda)


@pytest.mark.parametrize("kernel", DEGREE_COUNT_KERNELS)
def test_degree_count_sorted_hub_package(cuda, kernel):
    table = _sorted_table(cuda)
    hub = int((table[0] == 123).nonzero()[0])
    _count(table[:, hub : hub + 16384], 5000, kernel, cuda)
    assert bool((table[0, hub : hub + 16384] == 123).all())
    _count(table, 5000, kernel, cuda)


@pytest.mark.parametrize("kernel", DEGREE_COUNT_KERNELS)
def test_degree_count_padding_and_large_ids_interleaved(cuda, kernel):
    rng = np.random.default_rng(22)
    x = np.repeat(rng.choice([-1, 5, 6, 4095, 4096, 9999, 2**31 - 1], 5000), rng.integers(1, 30, 5000))
    ids = torch.from_numpy(np.stack([x, x[::-1]]).astype(np.int32)).to(cuda)
    _count(ids, 4096, kernel, cuda)


@pytest.mark.parametrize("kernel", DEGREE_COUNT_KERNELS)
def test_degree_count_row_slices_at_every_alignment(cuda, kernel):
    """A slice may start at any id: each offset mod 4 (16 bytes), each
    length mod 4, rows whose stride moves the alignment from row to row."""
    table = _sorted_table(cuda)
    for a in range(8):
        for m in (1, 2, 3, 4, 255, 256, 1021):
            _count(table[:, 1000 + a : 1000 + a + m], 5000, kernel, cuda)
    odd = torch.from_numpy(np.random.default_rng(23).integers(0, 300, (3, 4097)).astype(np.int32)).to(cuda)
    _count(odd[:, 1:], 300, kernel, cuda)  # row stride 4097: each row's head differs


@pytest.mark.parametrize("kernel", DEGREE_COUNT_KERNELS)
def test_degree_count_one_id_and_empty_rows(cuda, kernel):
    table = _sorted_table(cuda)
    _count(table[:, 5:6], 5000, kernel, cuda)
    _count(table[:1, 17:18], 5000, kernel, cuda)
    _count(table[:, 7:7], 5000, kernel, cuda)
    _count(table[:0], 5000, kernel, cuda)


@pytest.mark.parametrize("kernel", DEGREE_COUNT_KERNELS)
def test_degree_count_counters_not_a_power_of_two(cuda, kernel):
    rng = np.random.default_rng(24)
    src = np.sort(rng.integers(0, 3_000_000, 200_000))
    ids = torch.from_numpy((np.stack([src, rng.permutation(src)]) % 1_000_003).astype(np.int32)).to(cuda)
    _count(ids, 1_000_003, kernel, cuda)
    _count(ids[:, 3:150_001], 1_000_003, kernel, cuda)


def test_degree_count_path_rule_matches_the_source(cuda):
    lib = _degree_count_lib()
    for n, rows in ((PRIVATE_MIN_IDS, 1), (PRIVATE_MIN_IDS // 2, 2), (PRIVATE_MIN_IDS // 2 - 1, 2), (16384, 2)):
        assert lib.degree_count_path(n, rows) == {"runs": 0, "private": 1}[_degree_count_path(n, rows)]
    ids = torch.zeros(2, PRIVATE_MIN_IDS // 2, dtype=torch.int32, device=cuda)
    before = dict(degree_count_cuda.launches_by_path)
    degree_count_cuda(ids, torch.zeros(4, dtype=torch.int32, device=cuda))
    degree_count_cuda(ids[:, :16384], torch.zeros(4, dtype=torch.int32, device=cuda))
    assert degree_count_cuda.launches_by_path == {k: v + 1 for k, v in before.items()}


def test_wrappers_raise_instead_of_falling_back(cuda):
    rp = torch.tensor([0, 1], dtype=torch.int64, device=cuda)
    s = torch.zeros(1, dtype=torch.int32, device=cuda)
    blocks = torch.tensor([[0, 1], [-1, -1]], dtype=torch.int32, device=cuda)
    scratch = torch.zeros(2, 1, dtype=torch.int32, device=cuda)
    kw = dict(block_lo=0, block_hi=1, row_base=0, n_rows=1)
    with pytest.raises(ValueError, match="int64|int32|float32"):
        spmv_rows_cuda(rp.to(torch.int32), s, torch.zeros(1, device=cuda), blocks, scratch, **kw)
    for i in range(5):  # any one argument on the CPU
        args = [rp, s, torch.zeros(1, device=cuda), blocks, scratch]
        args[i] = args[i].cpu()
        with pytest.raises(ValueError, match="must be on"):
            spmv_rows_cuda(*args, **kw)
    with pytest.raises(ValueError, match="outside"):
        spmv_rows_cuda(rp, s, torch.zeros(1, device=cuda), blocks, scratch, **{**kw, "block_hi": 2})
    with pytest.raises(ValueError, match="int32"):
        degree_count_cuda(s.to(torch.int64), torch.zeros(4, dtype=torch.int32, device=cuda))


def test_cuda_backend_mixed_sessions(cuda):
    """fig20's tenant mix on a graph on the card: results equal the
    oracles, both kernels launched, modeled numbers equal the modeled
    backend's."""
    g = rmat_graph(12, seed=3, device=cuda)
    hubs = np.argsort(-g.out_degrees().cpu().numpy())
    kinds = ("pr_pull",) * 3 + ("bfs",) * 2 + ("degree_count",)

    def run(backend):
        made = []

        def mk(s, q):
            k = kinds[s]
            if k == "bfs":
                ex = alg.BFSExecutor(g, int(hubs[s % 8]))
            elif k == "pr_pull":
                ex = alg.PageRankExecutor(g, mode="pull", max_iters=4, tol=0)
            else:
                ex = alg.DegreeCountExecutor(g)
            made.append(ex)
            return ex

        eng = core.MultiQueryEngine(core.XEON_E5_2660V4, pool_capacity=16, policy="scheduler")
        cfg = core.EngineConfig(
            steal=True, fuse=True, hetero_fuse=True,
            fusion=core.FusionConfig(hold_ns=5e4, max_members=12), backend=backend,
        )
        rep = eng.run_sessions(mk, sessions=len(kinds), queries_per_session=1, config=cfg)
        assert eng.pool.available == eng.pool.capacity
        return rep, made

    s0, d0 = spmv_rows_cuda.launches, degree_count_cuda.launches
    rep, made = run("cuda")
    assert spmv_rows_cuda.launches > s0 and degree_count_cuda.launches > d0
    for ex in made:
        if isinstance(ex, alg.BFSExecutor):
            np.testing.assert_array_equal(ex.result(), alg.bfs_reference(g, ex.source))
        elif isinstance(ex, alg.DegreeCountExecutor):
            want = alg.degree_count_reference(g.src.cpu().numpy(), g.dst.cpu().numpy(), ex.num_counters)
            np.testing.assert_array_equal(ex.result(), want)
        else:
            np.testing.assert_allclose(ex.result(), alg.pagerank_reference(g, iters=4), rtol=2e-4, atol=1e-8)
    mrep, _ = run("modeled")
    assert rep.makespan_modeled_ns == mrep.makespan_modeled_ns
    assert [r.traces for r in rep.records] == [r.traces for r in mrep.records]


def _card_query(eng, ex):
    rec = core.QueryRecord(0, 0, ex.desc.name)
    eng.run_query(ex, rec)
    torch.cuda.synchronize()
    return rec


def test_cuda_backend_single_queries_equal_oracles_on_card(cuda):
    """The counterparts of the reference's ``PallasBackend`` lowering tests
    (tests/test_backends.py): one PageRank-pull, BFS and degree-count query
    each through ``backend="cuda"`` on a graph on the card, each equal to
    its oracle, each launching its kernel, with the card's measured time."""
    g = rmat_graph(10, seed=3, device=cuda)
    eng = core.MultiQueryEngine(core.XEON_E5_2660V4, policy="scheduler", backend="cuda")
    s0 = spmv_rows_cuda.launches
    pr = alg.PageRankExecutor(g, mode="pull", max_iters=5, tol=0)
    rec = _card_query(eng, pr)
    np.testing.assert_allclose(pr.result(), alg.pagerank_reference(g, iters=5), rtol=2e-4, atol=1e-8)
    assert rec.edges == pytest.approx(g.num_edges * 5) and rec.measured_ns > 0
    src = int(np.argmax(g.out_degrees().cpu().numpy()))
    bfs = alg.BFSExecutor(g, src)
    assert _card_query(eng, bfs).measured_ns > 0
    np.testing.assert_array_equal(bfs.result(), alg.bfs_reference(g, src))
    assert spmv_rows_cuda.launches > s0
    d0 = degree_count_cuda.launches
    dc = alg.DegreeCountExecutor(g)
    _card_query(eng, dc)
    assert degree_count_cuda.launches > d0
    want = alg.degree_count_reference(g.src.cpu().numpy(), g.dst.cpu().numpy(), dc.num_counters)
    np.testing.assert_array_equal(dc.result(), want)


def test_cuda_backend_results_stable_across_gang_widths_on_card(cuda):
    """A solo wide-gang query and a contended 4-session run with stealing
    (narrow, stolen, re-sliced gangs) give the same ranks on the card."""
    g = rmat_graph(10, seed=3, device=cuda)
    solo = alg.PageRankExecutor(g, mode="pull", max_iters=3, tol=0)
    _card_query(core.MultiQueryEngine(core.XEON_E5_2660V4, policy="scheduler", backend="cuda"), solo)
    made = []

    def mk(s, q):
        made.append(alg.PageRankExecutor(g, mode="pull", max_iters=3, tol=0))
        return made[-1]

    eng = core.MultiQueryEngine(core.XEON_E5_2660V4, pool_capacity=4, policy="scheduler", backend="cuda")
    eng.run_sessions(mk, sessions=4, queries_per_session=1, config=core.EngineConfig(steal=True))
    assert eng.pool.available == eng.pool.capacity
    for ex in made:
        np.testing.assert_allclose(ex.result(), solo.result(), rtol=1e-6)


def _skew_mk(g):
    hubs = np.argsort(-g.out_degrees().cpu().numpy())
    return lambda s, q: (alg.PageRankExecutor(g, mode="pull", max_iters=6, tol=0) if s == 0
                         else alg.BFSExecutor(g, int(hubs[s % 8])))


def test_cuda_measurements_reach_feedback_stolen_path_on_card(cuda):
    """Stolen batches carry the card's measured times into the §4.4 tables,
    as plain steps do (tests/test_backends.py's stolen-path test, on the
    ``cuda`` backend): every iteration observed once, width entries, and
    records that are no modeled echo."""
    g = rmat_graph(12, seed=3, device=cuda)
    fb = core.CostFeedback()
    eng = core.MultiQueryEngine(core.XEON_E5_2660V4, pool_capacity=16, policy="scheduler", feedback=fb,
                                backend="cuda")
    rep = eng.run_sessions(_skew_mk(g), sessions=8, queries_per_session=1,
                           config=core.EngineConfig(steal=True, width_feedback=True))
    assert rep.total_stolen > 0
    assert fb.observations == sum(r.iterations for r in rep.records)
    assert fb.width_observations > 0
    assert any(r.measured_ns != r.modeled_ns for r in rep.records)
    assert eng.pool.available == eng.pool.capacity


def test_cuda_measurements_reach_feedback_fused_path_on_card(cuda):
    """Fused split-back shares carry the card's measured times into the
    member records and the width table."""
    g = rmat_graph(12, seed=3, device=cuda)
    fb = core.CostFeedback()
    eng = core.MultiQueryEngine(core.XEON_E5_2660V4, pool_capacity=8, policy="scheduler", feedback=fb,
                                backend="cuda")
    rep = eng.run_sessions(lambda s, q: alg.PageRankExecutor(g, mode="pull", max_iters=3, tol=0), sessions=4,
                           queries_per_session=1, config=core.EngineConfig(fuse=True, width_feedback=True))
    assert rep.total_fused > 0
    assert fb.width_observations > 0
    assert all(r.measured_ns > 0 for r in rep.records)


def test_cuda_measurements_populate_width_table_on_card(cuda):
    g = rmat_graph(10, seed=3, device=cuda)
    hubs = np.argsort(-g.out_degrees().cpu().numpy())
    fb = core.CostFeedback()
    eng = core.MultiQueryEngine(core.XEON_E5_2660V4, pool_capacity=8, policy="scheduler", feedback=fb,
                                backend="cuda")
    rep = eng.run_sessions(lambda s, q: (alg.PageRankExecutor(g, mode="pull", max_iters=3, tol=0) if s == 0
                                         else alg.BFSExecutor(g, int(hubs[s % 4]))),
                           sessions=2, queries_per_session=1,
                           config=core.EngineConfig(steal=True, width_feedback=True))
    assert fb.width_observations > 0
    assert all(r.measured_ns > 0 for r in rep.records)


@pytest.mark.parametrize("b", [1, 4, 5, 16, 17, 63, 64, 70, 512])
@pytest.mark.parametrize("n,d", [(2048, 16), (6144, 256), (2048, 256), (6144, 16)])
def test_scoring_kernel_matches_plain(cuda, b, n, d):
    """Both kernels, across the dispatch threshold (4 | 5) and the
    streaming kernel's old one (16 | 17), a ragged tile (70), each counted on
    the path the rule names."""
    g = torch.Generator(device=cuda).manual_seed(b * 7 + n + d)
    q = _unit_rows((b, d), g, cuda)
    c = _unit_rows((n, d), g, cuda)
    path = _scoring_path(b, d)
    before, by_path = scoring_cuda.launches, dict(scoring_cuda.launches_by_path)
    got = scoring_cuda(q, c)
    assert scoring_cuda.launches == before + 1
    assert scoring_cuda.launches_by_path[path] == by_path[path] + 1
    torch.testing.assert_close(got, scoring_plain(q, c), rtol=SCORE_RTOL, atol=SCORE_ATOL)
    assert torch.equal(got, scoring_cuda(q, c))  # fixed summation order: bit-repeatable


def test_scoring_kernel_masks_ragged_depth_and_batch(cuda):
    g = torch.Generator(device=cuda).manual_seed(5)
    q = _unit_rows((70, 37), g, cuda)  # 70 queries: a second, ragged query tile
    c = _unit_rows((4096, 37), g, cuda)
    torch.testing.assert_close(scoring_cuda(q, c), scoring_plain(q, c), rtol=SCORE_RTOL, atol=SCORE_ATOL)


def test_scoring_stream_kernel_takes_large_batches_of_ragged_depth(cuda):
    """D % 4 != 0 keeps even B = 512 on the streaming kernel: 32 chunks of
    16 queries, scalar loads."""
    g = torch.Generator(device=cuda).manual_seed(37)
    q = _unit_rows((512, 37), g, cuda)
    c = _unit_rows((4096, 37), g, cuda)
    before = scoring_cuda.launches_by_path["stream"]
    torch.testing.assert_close(scoring_cuda(q, c), scoring_plain(q, c), rtol=SCORE_RTOL, atol=SCORE_ATOL)
    assert scoring_cuda.launches_by_path["stream"] == before + 1


@pytest.mark.parametrize("b", [4, 512])
def test_scoring_split_keeps_relative_error_on_large_rows(cuda, b):
    """Non-negative unit rows scaled by 10^3: scores ~6e5 without
    cancellation, held by the tolerance's relative part, which one TF32
    product (2^-11) misses and the 3xTF32 split meets."""
    g = torch.Generator(device=cuda).manual_seed(b)
    q = _unit_rows((b, 256), g, cuda).abs() * 1e3
    c = _unit_rows((4096, 256), g, cuda).abs() * 1e3
    torch.testing.assert_close(scoring_cuda(q, c), scoring_plain(q, c), rtol=SCORE_RTOL, atol=SCORE_ATOL)


SCORING_VARIANTS = [("stream", w) for w in (1, 2, 4, 8, 16)] + [("tc", w) for w in (8, 16, 32, 64, 128)]


@pytest.mark.parametrize("path,width", SCORING_VARIANTS)
@pytest.mark.parametrize("b,d", [(3, 256), (37, 36), (300, 260)])
def test_scoring_variants_match_plain(cuda, path, width, b, d):
    """Every instantiation of both kernels, narrower and wider than B."""
    g = torch.Generator(device=cuda).manual_seed(width + b + d)
    q = _unit_rows((b, d), g, cuda)
    c = _unit_rows((4096, d), g, cuda)
    before = scoring_cuda.launches_by_path[path]
    got = _scoring_variant(q, c, path, width)
    assert scoring_cuda.launches_by_path[path] == before + 1
    torch.testing.assert_close(got, scoring_plain(q, c), rtol=SCORE_RTOL, atol=SCORE_ATOL)


def test_scoring_stream_kernel_takes_misaligned_rows(cuda):
    """Candidates off a 16-byte boundary: the streaming kernel loads them
    one float at a time; the tensor-core kernel refuses them (TMA)."""
    g = torch.Generator(device=cuda).manual_seed(9)
    flat = torch.empty(2048 * 64 + 1, device=cuda)
    c = flat[1:].view(2048, 64)
    c.copy_(_unit_rows((2048, 64), g, cuda))
    q = _unit_rows((STREAM_MAX_BATCH, 64), g, cuda)
    torch.testing.assert_close(scoring_cuda(q, c), scoring_plain(q, c), rtol=SCORE_RTOL, atol=SCORE_ATOL)
    with pytest.raises(ValueError, match="16-byte"):
        scoring_cuda(_unit_rows((64, 64), g, cuda), c)


def test_scoring_dispatch_rule_matches_the_source(cuda):
    assert _lib().scoring_stream_max_batch() == STREAM_MAX_BATCH


@pytest.mark.parametrize("d", [256, 16, 6])
def test_embedding_bag_kernel_matches_plain(cuda, d):
    rng = np.random.default_rng(d)
    v, n, bags = 3000, 5000, 700
    table = torch.from_numpy(rng.normal(size=(v, d)).astype(np.float32)).to(cuda)
    ids = rng.integers(0, v, n).astype(np.int32)
    ids[:50] = 17  # repeated ids
    segs = np.sort(rng.integers(0, bags, n)).astype(np.int32)
    segs[segs == 3] = 4  # bag 3 empty
    w = rng.normal(size=n).astype(np.float32)
    w[::7] = 0.0  # weight-0 ids (the fixed hot-size padding)
    ids_t, segs_t, w_t = (torch.from_numpy(a).to(cuda) for a in (ids, segs, w))
    for weights in (None, w_t):
        before = embedding_bag_cuda.launches
        got = embedding_bag_cuda(table, ids_t, segs_t, weights, bags)
        again = embedding_bag_cuda(table, ids_t, segs_t, weights, bags)
        assert embedding_bag_cuda.launches == before + 2
        want = embedding_bag_plain(table, ids_t, segs_t, weights, bags)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        assert torch.equal(got, again)  # no atomics: bit-repeatable
        assert not got[3].any()
    # trailing bags with no ids at all, and no ids at all
    out = embedding_bag_cuda(table, ids_t[:10], segs_t[:10], None, bags)
    assert not out[int(segs_t[9]) + 1 :].any()
    assert not embedding_bag_cuda(table, ids_t[:0], segs_t[:0], None, 5).any()


def _bags_in_id_order(table, ids, segs, weights, bags):
    """float32 bag sums adding each row (scaled by its weight, one rounding)
    in id order, one rounding per add: the kernel's order, bit for bit."""
    t, i, s = table.cpu().numpy(), ids.cpu().numpy(), segs.cpu().numpy()
    w = None if weights is None else weights.cpu().numpy()
    out = np.zeros((bags, t.shape[1]), np.float32)
    for k in range(i.shape[0]):
        row = t[i[k]] if w is None else w[k] * t[i[k]]
        out[s[k]] = out[s[k]] + row
    return torch.from_numpy(out)


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("d", [4, 6, 256])
def test_embedding_bag_kernel_bag_lengths(cuda, d, weighted):
    """Bags of 0, 1, 7, 32 and 1,000 ids (past the kernel's loads in
    flight, and past its search's first window), on float4 rows (D = 4,
    256) and scalar ones (D = 6), and on a table view 4 bytes off a 16-byte
    boundary; one launch a call, the bits of the sums in id order, twice.
    The plain version's atomic adds take a 1,000-id bag of unit-normal rows
    (sums up to ~100) in another order, some float32 steps of those sums
    away: 1e-4 absolute."""
    rng = np.random.default_rng(d + weighted)
    v = 5000
    lens = np.array([0, 1, 7, 32, 1000, 0, 32, 7, 1, 0] * 3)
    bags = lens.shape[0]
    segs = np.repeat(np.arange(bags), lens).astype(np.int32)
    n = segs.shape[0]
    ids = torch.from_numpy(rng.integers(0, v, n).astype(np.int32)).to(cuda)
    segs_t = torch.from_numpy(segs).to(cuda)
    w = torch.from_numpy(rng.normal(size=n).astype(np.float32)).to(cuda) if weighted else None
    flat = torch.from_numpy(rng.normal(size=v * d + 1).astype(np.float32)).to(cuda)
    for table in (flat[: v * d].view(v, d), flat[1:].view(v, d)):  # aligned, then 4 B off
        before = embedding_bag_cuda.launches
        got = embedding_bag_cuda(table, ids, segs_t, w, bags)
        again = embedding_bag_cuda(table, ids, segs_t, w, bags)
        assert embedding_bag_cuda.launches == before + 2
        assert torch.equal(got, again)
        assert torch.equal(got.cpu(), _bags_in_id_order(table, ids, segs_t, w, bags))
        want = embedding_bag_plain(table, ids, segs_t, w, bags)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
        assert not got[torch.from_numpy(lens == 0).to(cuda)].any()


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_out_of_range_segments_on_card_equal_cpu(cuda, mode):
    """Ids whose segment lies outside [0, num_bags) fall in no bag on the
    card (the kernel's search leaves them out) as on the CPU (the plain
    version's dump row)."""
    rng = np.random.default_rng(17)
    table = rng.normal(size=(400, 256)).astype(np.float32)
    ids = rng.integers(0, 400, 3000).astype(np.int32)
    segs = rng.integers(-20, 140, 3000).astype(np.int32)
    w = rng.normal(size=3000).astype(np.float32)
    for weights in (None, w):
        args = (table, ids, segs)
        cpu = layers.embedding_bag(*(torch.from_numpy(a) for a in args), 120, mode=mode,
                                   weights=None if weights is None else torch.from_numpy(weights))
        before = embedding_bag_cuda.launches
        card = layers.embedding_bag(*(torch.from_numpy(a).to(cuda) for a in args), 120, mode=mode,
                                    weights=None if weights is None else torch.from_numpy(weights).to(cuda))
        assert embedding_bag_cuda.launches == before + 1
        torch.testing.assert_close(card.cpu(), cpu, rtol=1e-5, atol=1e-6)


def test_new_wrappers_raise_instead_of_falling_back(cuda):
    q = torch.zeros(2, 8, device=cuda)
    c = torch.zeros(2048, 8, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        scoring_cuda(q.double(), c)
    with pytest.raises(ValueError, match="must be on"):
        scoring_cuda(q.cpu(), c)
    with pytest.raises(ValueError, match="contiguous"):
        scoring_cuda(torch.zeros(8, 2, device=cuda).T, c)
    with pytest.raises(ValueError, match="multiple"):
        scoring_cuda(q, c[:2000])
    table = torch.zeros(10, 4, device=cuda)
    ids = torch.zeros(3, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="int32"):
        embedding_bag_cuda(table, ids.long(), ids, None, 2)
    with pytest.raises(ValueError, match="must be on"):
        embedding_bag_cuda(table, ids.cpu(), ids, None, 2)
    with pytest.raises(ValueError, match="contiguous"):
        embedding_bag_cuda(torch.zeros(4, 10, device=cuda).T, ids, ids, None, 2)


def test_two_tower_on_card_equals_cpu(cuda):
    cfg = TwoTowerConfig(
        embed_dim=32, tower_mlp=(64, 32),
        user_fields=(FieldSpec("user_id", 4096), FieldSpec("user_history", 2048, multi_hot=8)),
        item_fields=(FieldSpec("item_id", 4096), FieldSpec("item_tags", 512, multi_hot=4)),
    )
    cpu = TwoTower(cfg, seed=1, device="cpu")
    card = TwoTower(cfg, seed=2, device=cuda)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(3)

    def feats(fields, b):
        out = {f.name: rng.integers(0, f.vocab, (b, f.multi_hot)).astype(np.int32) for f in fields}
        out[fields[1].name + "_w"] = rng.random((b, fields[1].multi_hot)).astype(np.float32)
        return out

    items = feats(cfg.item_fields, 4000)
    users = feats(cfg.user_fields, 8)
    to = lambda fs, dev: {k: torch.from_numpy(v).to(dev) for k, v in fs.items()}  # noqa: E731
    corpus_cpu = cpu.item_embedding(to(items, "cpu"), 4000)
    corpus_card = card.item_embedding(to(items, cuda), 4000)
    torch.testing.assert_close(corpus_card.cpu(), corpus_cpu, rtol=1e-5, atol=1e-6)
    s0, e0 = scoring_cuda.launches, embedding_bag_cuda.launches
    v_card, i_card = card.score_candidates(to(users, cuda), corpus_card, top_k=16)
    assert scoring_cuda.launches == s0 + 1 and embedding_bag_cuda.launches == e0 + 2
    v_cpu, i_cpu = cpu.score_candidates(to(users, "cpu"), corpus_cpu, top_k=16)
    torch.testing.assert_close(v_card.cpu(), v_cpu, rtol=1e-5, atol=1e-5)
    assert torch.equal(i_card.cpu(), i_cpu)


@pytest.mark.parametrize("dh", [16, 32, 64, 128])
@pytest.mark.parametrize("h,kh", [(4, 4), (4, 2), (32, 4), (48, 1), (48, 8), (56, 8)])
@pytest.mark.parametrize("s", [1, 64, 127, 128, 129, 200, 1000])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_flash_attention_kernel_matches_plain(cuda, dh, h, kh, s, dtype):
    """G = H / K of 1, the smoke configs' 2, 8, 48, and grok-1's 6 and
    arctic's 7; head dims of the smoke configs (16) and the served ones; S of one key,
    one float32 tile, a ragged 128-row block, exactly one, the first row
    past it, a ragged fourth float32 tile, and many tiles."""
    g = torch.Generator(device=cuda).manual_seed(s * 7 + dh + h)
    dt = getattr(torch, dtype)
    q = torch.randn(2, s, h, dh, device=cuda, generator=g).to(dt)
    k = torch.randn(2, s, kh, dh, device=cuda, generator=g).to(dt)
    v = torch.randn(2, s, kh, dh, device=cuda, generator=g).to(dt)
    before = flash_attention_cuda.launches
    got = flash_attention_cuda(q, k, v)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1 and got.dtype == dt
    want = flash_attention_plain(q, k, v, block_kv=64)
    if dtype == "float32":
        torch.testing.assert_close(got, want, rtol=FLASH_TOL, atol=FLASH_TOL)
    elif dtype == "bfloat16":
        torch.testing.assert_close(got, want, rtol=FLASH_BF16_RTOL, atol=FLASH_BF16_ATOL)
    else:
        torch.testing.assert_close(got, want, rtol=FLASH_F16_TOL, atol=FLASH_F16_TOL)


def test_flash_attention_kernel_long_sequence(cuda):
    """Rows far past the first tiles: the online softmax's rescaling over
    35 tiles, in float16 too."""
    g = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = (torch.randn(1, 2222, 8, 64, device=cuda, generator=g) for _ in range(3))
    k, v = k[:, :, :2].contiguous(), v[:, :, :2].contiguous()
    want = flash_attention_plain(q, k, v, block_kv=512)
    torch.testing.assert_close(flash_attention_cuda(q, k, v), want, rtol=FLASH_TOL, atol=FLASH_TOL)
    half = flash_attention_cuda(q.half(), k.half(), v.half())
    torch.testing.assert_close(half, flash_attention_plain(q.half(), k.half(), v.half()),
                               rtol=FLASH_F16_TOL, atol=FLASH_F16_TOL)


def test_flash_attention_wrapper_raises_instead_of_falling_back(cuda):
    q = torch.zeros(1, 8, 4, 64, device=cuda)
    kv = torch.zeros(1, 8, 2, 64, device=cuda)
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention_cuda(q.cpu(), kv.cpu(), kv.cpu())
    with pytest.raises(ValueError, match="share one of"):
        flash_attention_cuda(q.double(), kv.double(), kv.double())
    with pytest.raises(ValueError, match="share one of"):
        flash_attention_cuda(q.bfloat16(), kv, kv)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_cuda(q.transpose(1, 2), kv, kv)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_cuda(q[..., :48].contiguous(), kv[..., :48].contiguous(), kv[..., :48].contiguous())
    with pytest.raises(ValueError, match="multiple"):
        flash_attention_cuda(q[:, :, :3].contiguous(), kv, kv)
    # a contiguous bf16 view 2 bytes past a 16-byte boundary: TMA cannot read it
    flat = torch.zeros(1 + q.numel(), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_cuda(flat[1:].view(q.shape), kv.bfloat16(), kv.bfloat16())


@pytest.mark.parametrize("b,s,h,kh,dh", [(2, 200, 8, 2, 64), (1, 129, 6, 1, 128), (2, 77, 4, 4, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_gradient_on_card_matches_plain_autograd(cuda, b, s, h, kh, dh, dtype):
    """``FlashAttention`` (the kernel's forward, the plain blocked backward)
    against autograd through the kernel's plain version, on the card, with a
    ragged last block. float32: the same float32 math in another order, so
    within 1e-4 of each gradient's largest entry; bf16: both cast float32
    gradients to bf16, and D = rowsum(dO * O) reads the kernel's bf16 output,
    which may sit a bf16 step from the plain one: within two bf16 steps
    (2**-6) relative, 1e-2 of the largest entry absolute."""
    from repro_torch.kernels.attention import FlashAttention

    g = torch.Generator(device=cuda).manual_seed(s + dh)
    dt = getattr(torch, dtype)
    q = torch.randn(b, s, h, dh, device=cuda, generator=g).to(dt)
    k, v = (torch.randn(b, s, kh, dh, device=cuda, generator=g).to(dt) for _ in range(2))
    dout = torch.randn(b, s, h, dh, device=cuda, generator=g).to(dt)
    got_in = [x.clone().requires_grad_() for x in (q, k, v)]
    want_in = [x.clone().requires_grad_() for x in (q, k, v)]
    before = flash_attention_cuda.launches
    out = FlashAttention.apply(*got_in, 64)
    out.backward(dout)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 1
    flash_attention_plain(*want_in, block_kv=64).backward(dout)
    for got, want in zip(got_in, want_in):
        assert got.grad.dtype == dt
        scale = float(want.grad.float().abs().max())
        if dtype == "float32":
            torch.testing.assert_close(got.grad, want.grad, rtol=0, atol=1e-4 * scale)
        else:
            torch.testing.assert_close(got.grad.float(), want.grad.float(), rtol=2**-6, atol=1e-2 * scale)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("dh", [8, 24, 48, 96, 256])
def test_flash_attention_refuses_head_dims_it_is_not_built_for(cuda, dh, dtype):
    """Head dims outside ``HEAD_DIMS`` raise on both paths, before any
    launch, whatever the type: no fallback to the plain version."""
    q = torch.zeros(1, 8, 4, dh, device=cuda, dtype=getattr(torch, dtype))
    kv = torch.zeros(1, 8, 2, dh, device=cuda, dtype=q.dtype)
    before = flash_attention_cuda.launches
    with pytest.raises(ValueError, match=f"head dim {dh} is not one of"):
        flash_attention_cuda(q, kv, kv)
    assert flash_attention_cuda.launches == before


def test_lm_train_step_on_card_equals_cpu(cuda):
    """One AdamW step of a small config (head dim 64, beside the smoke
    configs' 16 below; S = 40 > block_kv, two microbatches, remat) on the
    card against the same step on the CPU:
    two flash launches a layer and microbatch (the forward and its
    recomputation), and the same loss, gradient norm and weights. AdamW's
    eps is 1e-4 (tests/test_torch_train.py: a default-eps step of an element
    whose gradient is within float32 noise of zero may take either sign)."""
    from repro_torch.launch.steps import lm_train_step
    from repro_torch._tree import tree_leaves
    from repro_torch.optim import OptimizerConfig, adamw_init

    cfg = tf.LMConfig(name="card-train", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2, head_dim=64,
                      d_ff=256, vocab=300, dtype=torch.float32, block_kv=16, microbatches=2, remat=True)
    opt = OptimizerConfig(lr=1e-3, warmup_steps=0, decay_steps=10, eps=1e-4)
    cpu = tf.TransformerLM(cfg, seed=3, device="cpu", masters=True)
    card = tf.TransformerLM(cfg, seed=4, device=cuda, masters=True)
    card.load_state_dict(cpu.state_dict())
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (4, 41)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks[:, :-1]), "labels": torch.from_numpy(toks[:, 1:].copy())}
    before = flash_attention_cuda.launches
    card, card_st, m = lm_train_step(cfg, opt)(card, adamw_init(tf.params_tree(card)),
                                               {k: v.to(cuda) for k, v in batch.items()})
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 2 * cfg.n_layers * cfg.microbatches
    cpu, cpu_st, want = lm_train_step(cfg, opt)(cpu, adamw_init(tf.params_tree(cpu)), batch)
    torch.testing.assert_close(m["loss"].cpu(), want["loss"], rtol=1e-5, atol=0)
    torch.testing.assert_close(m["gnorm"].cpu(), want["gnorm"], rtol=1e-4, atol=0)
    for a, b in zip(tree_leaves(tf.params_tree(card)), tree_leaves(tf.params_tree(cpu))):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-6)
    assert int(card_st["step"]) == 1


def _card_lm():
    cfg = tf.LMConfig(name="card", n_layers=3, d_model=128, n_heads=4, n_kv_heads=2, head_dim=64,
                      d_ff=256, vocab=300, dtype=torch.float32, block_kv=16)
    return cfg, tf.TransformerLM(cfg, seed=3, device="cpu")


def test_prefill_on_card_launches_the_kernel_and_equals_cpu(cuda):
    cfg, cpu = _card_lm()
    card = tf.TransformerLM(cfg, seed=4, device=cuda)
    card.load_state_dict(cpu.state_dict())
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab, (2, 77)).astype(np.int32))
    before = flash_attention_cuda.launches
    logits, cache = tf.prefill(cfg, card, toks.to(cuda), 80)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + cfg.n_layers
    want, want_cache = tf.prefill(cfg, cpu, toks, 80)
    torch.testing.assert_close(logits.cpu(), want, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(cache["k"].cpu(), want_cache["k"], rtol=1e-4, atol=1e-5)
    # the decode path (plain torch) continues from the card's cache
    nxt = logits.argmax(-1, keepdim=True).to(torch.int32)
    step, cache = tf.decode_step(cfg, card, nxt, cache)
    assert step.shape == (2, cfg.vocab) and cache["len"].tolist() == [78, 78]


def _moe_case(residual: bool, seed: int):
    rng = np.random.default_rng(seed)
    d, f, e = 64, 96, 4
    n = lambda *shape: torch.from_numpy((rng.standard_normal(shape) * 0.1).astype(np.float32))  # noqa: E731
    w = {"w_router": n(d, e), "wi_gate": n(e, d, f), "wi_up": n(e, d, f), "wo": n(e, f, d)}
    if residual:
        w["residual"] = {"wi_gate": n(d, f), "wi_up": n(d, f), "wo": n(f, d)}
    return w, torch.from_numpy(rng.standard_normal((4, 32, d)).astype(np.float32))


@pytest.mark.parametrize("dispatch,groups", [("dense", 1), ("gather", 1), ("gather", 16)])
@pytest.mark.parametrize("cf", [1.25, 0.5])
def test_moe_block_on_card_equals_cpu(cuda, dispatch, groups, cf):
    """The same routing (experts and the dense keep rule) and, in float32,
    the same outputs as on the CPU, with capacity binding (0.5) and not."""
    w, x = _moe_case(True, 5)
    cfg = moe.MoEConfig(num_experts=4, capacity_factor=cf, dispatch=dispatch, dispatch_groups=groups,
                        dense_residual=True)
    to = lambda tree: {k: to(v) if isinstance(v, dict) else v.to(cuda) for k, v in tree.items()}  # noqa: E731
    _, _, idx = moe.route(w, x.reshape(-1, 64), cfg)
    _, _, idx_card = moe.route(to(w), x.reshape(-1, 64).to(cuda), cfg)
    assert torch.equal(idx_card.cpu(), idx)
    assert torch.equal(moe.dense_positions(idx_card, 4).cpu(), moe.dense_positions(idx, 4))
    want, want_aux = moe.moe_block(w, x, cfg)
    got, aux = moe.moe_block(to(w), x.to(cuda), cfg)
    assert got.device.type == "cuda"
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(aux.cpu(), want_aux, rtol=1e-5, atol=1e-6)


def test_moe_prefill_on_card_launches_the_kernel_and_equals_cpu(cuda):
    """A small grok-like config at a served head dim (64; the smoke configs'
    16 runs below): one launch a layer, logits and caches as on the CPU,
    then a decode step."""
    cfg = tf.LMConfig(name="card-moe", n_layers=2, d_model=128, n_heads=6, n_kv_heads=1, head_dim=64,
                      d_ff=256, vocab=300, dtype=torch.float32, block_kv=16,
                      moe=moe.MoEConfig(num_experts=4, capacity_factor=1.0, dense_residual=True))
    cpu = tf.TransformerLM(cfg, seed=3, device="cpu")
    card = tf.TransformerLM(cfg, seed=4, device=cuda)
    card.load_state_dict(cpu.state_dict())
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab, (2, 77)).astype(np.int32))
    before = flash_attention_cuda.launches
    logits, cache = tf.prefill(cfg, card, toks.to(cuda), 80)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + cfg.n_layers
    want, want_cache = tf.prefill(cfg, cpu, toks, 80)
    torch.testing.assert_close(logits.cpu(), want, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(cache["k"].cpu(), want_cache["k"], rtol=1e-4, atol=1e-5)
    nxt = logits.argmax(-1, keepdim=True).to(torch.int32)
    step, cache = tf.decode_step(cfg, card, nxt, cache)
    want_step, _ = tf.decode_step(cfg, cpu, nxt.cpu(), want_cache)
    torch.testing.assert_close(step.cpu(), want_step, rtol=1e-4, atol=1e-5)


# the five LM archs' smoke configs (head dim 16, float32), the MoE ones under
# both dispatches
SMOKE_CASES = [("tinyllama-1.1b", None), ("stablelm-1.6b", None), ("granite-34b", None),
               ("grok-1-314b", "dense"), ("grok-1-314b", "gather"),
               ("arctic-480b", "dense"), ("arctic-480b", "gather")]


def _smoke_cfg(arch, dispatch, **over):
    from repro_torch.configs import get_arch

    cfg = get_arch(arch).make_smoke_config()
    if dispatch is not None:
        over["moe"] = dataclasses.replace(cfg.moe, dispatch=dispatch)
    return dataclasses.replace(cfg, **over)


@pytest.mark.parametrize("arch,dispatch", SMOKE_CASES)
def test_smoke_config_prefill_on_card_launches_the_kernel_and_equals_cpu(cuda, arch, dispatch):
    """Prefill of each smoke config (Dh = 16, S = 77 > block_kv) through
    the kernel, one launch a layer, logits and caches as on the CPU (the
    tolerances of the head-dim-64 test above), then a decode step."""
    cfg = _smoke_cfg(arch, dispatch)
    assert cfg.dh == 16
    cpu = tf.TransformerLM(cfg, seed=3, device="cpu")
    card = tf.TransformerLM(cfg, seed=4, device=cuda)
    card.load_state_dict(cpu.state_dict())
    toks = torch.from_numpy(np.random.default_rng(4).integers(0, cfg.vocab, (2, 77)).astype(np.int32))
    before = flash_attention_cuda.launches
    logits, cache = tf.prefill(cfg, card, toks.to(cuda), 80)
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + cfg.n_layers
    want, want_cache = tf.prefill(cfg, cpu, toks, 80)
    torch.testing.assert_close(logits.cpu(), want, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(cache["k"].cpu(), want_cache["k"], rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(cache["v"].cpu(), want_cache["v"], rtol=1e-4, atol=1e-5)
    nxt = logits.argmax(-1, keepdim=True).to(torch.int32)
    step, cache = tf.decode_step(cfg, card, nxt, cache)
    want_step, _ = tf.decode_step(cfg, cpu, nxt.cpu(), want_cache)
    torch.testing.assert_close(step.cpu(), want_step, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("arch,dispatch", SMOKE_CASES)
def test_smoke_config_train_step_on_card_equals_cpu(cuda, arch, dispatch):
    """One AdamW step of each smoke config (Dh = 16, S = 40 > block_kv, two
    microbatches, remat) on the card against the CPU, as
    ``test_lm_train_step_on_card_equals_cpu`` holds the head-dim-64 config:
    two launches a layer and microbatch, the same loss, gradient norm and
    weights; AdamW's eps 1e-4 for the reason given there."""
    from repro_torch.launch.steps import lm_train_step
    from repro_torch._tree import tree_leaves
    from repro_torch.optim import OptimizerConfig, adamw_init

    cfg = _smoke_cfg(arch, dispatch, microbatches=2, remat=True)
    opt = OptimizerConfig(lr=1e-3, warmup_steps=0, decay_steps=10, eps=1e-4)
    cpu = tf.TransformerLM(cfg, seed=3, device="cpu", masters=True)
    card = tf.TransformerLM(cfg, seed=4, device=cuda, masters=True)
    card.load_state_dict(cpu.state_dict())
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (4, 41)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks[:, :-1]), "labels": torch.from_numpy(toks[:, 1:].copy())}
    before = flash_attention_cuda.launches
    card, card_st, m = lm_train_step(cfg, opt)(card, adamw_init(tf.params_tree(card)),
                                               {k: v.to(cuda) for k, v in batch.items()})
    torch.cuda.synchronize()
    assert flash_attention_cuda.launches == before + 2 * cfg.n_layers * cfg.microbatches
    cpu, cpu_st, want = lm_train_step(cfg, opt)(cpu, adamw_init(tf.params_tree(cpu)), batch)
    torch.testing.assert_close(m["loss"].cpu(), want["loss"], rtol=1e-5, atol=0)
    torch.testing.assert_close(m["gnorm"].cpu(), want["gnorm"], rtol=1e-4, atol=0)
    for a, b in zip(tree_leaves(tf.params_tree(card)), tree_leaves(tf.params_tree(cpu))):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-6)
    assert int(card_st["step"]) == 1


def test_trainer_runs_with_its_defaults_on_card(cuda):
    """``python -m repro_torch.launch.train`` with no arguments: TinyLlama's
    smoke config (Dh = 16, no remat, one microbatch), 100 steps of 8 × 128
    tokens on the card, one launch a layer and step (S = 128 > block_kv),
    and the last logged loss below step 0's."""
    from repro_torch.launch import train

    before = flash_attention_cuda.launches
    out = train.main([])
    torch.cuda.synchronize()
    cfg = train.build_small_lm("tinyllama-1.1b")
    assert next(out["model"].parameters()).device.type == "cuda"
    assert len(out["step_s"]) == 100
    assert flash_attention_cuda.launches - before == 100 * cfg.n_layers
    assert out["losses"][-1][1] < out["losses"][0][1]


def test_serving_engine_drains_on_card(cuda):
    from repro_torch.serving import Request, ServingEngine

    cfg, cpu = _card_lm()
    card = tf.TransformerLM(cfg, seed=0, device=cuda)
    eng = ServingEngine(cfg, card, max_batch=3, max_len=32, hw=core.XEON_E5_2660V4)
    assert eng.cache["k"].device.type == "cuda" and eng.cache["k"].dtype == torch.float32
    rng = np.random.default_rng(1)
    reqs = [Request(r, rng.integers(1, cfg.vocab, 5).astype(np.int32), max_new_tokens=4) for r in range(4)]
    for r in reqs:
        eng.submit(r)
    assert eng.run_until_drained() == 16
    assert all(r.done and len(r.generated) == 4 for r in reqs) and all(w >= 1 for w in eng.plans)


def test_datasets_and_epoch_snapshots_land_on_card(cuda):
    from repro_torch.graph import GraphEpochLog, load_dataset

    for name in ("roadNet-PA", "web-BerkStan"):
        g = load_dataset(name, scale_div=512, device=None)
        assert g.device.type == "cuda" and g.surrogate
        want = load_dataset(name, scale_div=512, device="cpu")
        assert g.key == want.key and torch.equal(g.csr_in.indices.cpu(), want.csr_in.indices)
    log = GraphEpochLog(g)
    rng = np.random.default_rng(0)
    g1 = log.ingest(rng.integers(0, g.num_vertices, 100), rng.integers(0, g.num_vertices, 100))
    tensors = (g1.csr.indptr, g1.csr.indices, g1.csr_in.indptr, g1.csr_in.indices, g1.src, g1.dst)
    assert g1.epoch == 1 and all(t.device.type == "cuda" and t.dtype == torch.int32 for t in tensors)
    assert g1.num_edges == g.num_edges + 100


def test_dynamic_run_on_card_equals_cpu(cuda):
    """fig22's dynamic run at RMAT scale 10 with its snapshots on the card
    gives the same records (wall times aside) and results as on the CPU."""
    from _torch_bench_rows import run_fig22

    s0 = spmv_rows_cuda.launches
    rep, pinned, log = run_fig22(True, scale=10, backend="cuda", device=cuda)
    assert spmv_rows_cuda.launches > s0 and log.current().device.type == "cuda"
    want, want_pinned, _ = run_fig22(True, scale=10, backend="cuda", device="cpu")

    def fields(r):
        wall = ("measured_ns", "submitted_wall_ns", "finished_wall_ns")
        return {k: v for k, v in dataclasses.asdict(r).items() if k not in wall}

    assert [fields(r) for r in rep.records] == [fields(r) for r in want.records]
    assert rep.ingest_events == want.ingest_events and rep.epochs_published == 6
    for key, ex in pinned.items():
        assert ex.graph.epoch == want_pinned[key].graph.epoch
        if isinstance(ex, alg.BFSExecutor):
            np.testing.assert_array_equal(ex.result(), want_pinned[key].result())
            np.testing.assert_array_equal(ex.result(), alg.bfs_reference(ex.graph, ex.source))
        else:
            np.testing.assert_allclose(ex.result(), want_pinned[key].result(), rtol=2e-4, atol=1e-8)


def test_block_to_device_defaults_to_card(cuda):
    from repro_torch.graph import block_to_device, sample_fanout

    g = rmat_graph(9, seed=3, device=cuda)
    block = sample_fanout(g, np.array([1, 2, 3]), (4, 3), seed=1)
    got = block_to_device(block)
    assert all(t.device.type == "cuda" for t in got.values())
    want = block_to_device(block, device="cpu")
    assert all(torch.equal(got[k].cpu(), want[k]) for k in want)


# ---------------- the GNN family (models/gnn) ----------------

@pytest.mark.parametrize("how", ["sum", "mean", "max", "min"])
def test_gnn_aggregate_on_card_equals_cpu(cuda, how):
    """``aggregate`` on the card: the CPU's values, ids outside ``[0, n)``
    (-1, n, n + 5) dropped, empty rows 0, and its gradient."""
    from repro_torch.models.gnn.common import aggregate

    rng = np.random.default_rng(3)
    msg = torch.from_numpy(rng.normal(size=(5000, 24)).astype(np.float32))
    ids = rng.integers(0, 700, 5000).astype(np.int32)
    ids[:30] = [-1, 700, 705] * 10
    ids[ids == 7] = 8  # row 7 receives nothing
    ids = torch.from_numpy(ids)
    cot = torch.from_numpy(rng.normal(size=(700, 24)).astype(np.float32))
    got_in = msg.to(cuda).requires_grad_()
    got = aggregate(got_in, ids.to(cuda), 700, how)
    got.backward(cot.to(cuda))
    want_in = msg.clone().requires_grad_()
    want = aggregate(want_in, ids, 700, how)
    want.backward(cot)
    torch.testing.assert_close(got.detach().cpu(), want.detach(), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got_in.grad.cpu(), want_in.grad, rtol=1e-5, atol=1e-6)
    assert not got[7].any() and not got_in.grad[:30].any()


@pytest.mark.parametrize("arch,blocked", CARD_CASES, ids=[f"{a}{'-blocked' if b else ''}" for a, b in CARD_CASES])
def test_gnn_smoke_config_on_card_equals_cpu(cuda, arch, blocked):
    """Each GNN smoke config's forward and one AdamW ``gnn_train_step`` on
    the card against the CPU on the same weights and batch (GraphCast also
    on its owner-blocked layout, P = 4): ``_torch_gnn.card_equals_cpu``,
    the case ``chip_smoke.py``'s phase 13 also runs."""
    card_equals_cpu(arch, blocked, cuda, np.random.default_rng(6), seed=3)


def _bag_grads(fn, table, ids, segs, w, cot):
    """The forward and the table's and weights' gradients of ``fn(table,
    ids, segs, w)`` for the cotangent ``cot``."""
    t, tw = table.clone().requires_grad_(), w.clone().requires_grad_()
    out = fn(t, ids, segs, tw)
    out.backward(cot)
    return out.detach(), t.grad, tw.grad


@pytest.mark.parametrize("case", ["zipf_history", "tags", "id_rule"])
def test_embedding_bag_function_on_card_matches_plain_autograd(cuda, case):
    """``EmbeddingBagFunction`` (the kernel's forward, the plain backward)
    against autograd through the plain version on the card: bags of 32 Zipf
    ids (many repeats of a few rows, as the training stream's history), of
    8 uniform ids, and bags holding ids -1, -V, V and V + 5 (NaN bags, the
    wrapped ids' gradients on their rows). One launch a forward. The table's
    gradient sums a hot row's terms with atomics in another order than the
    plain path's: within 1e-4 of its largest entry."""
    rng = np.random.default_rng(len(case))
    v, d, bags, hot = {"zipf_history": (4096, 256, 512, 32), "tags": (2048, 256, 4096, 8),
                       "id_rule": (300, 16, 64, 8)}[case]
    ids = (rng.zipf(1.2, (bags, hot)) % v) if case == "zipf_history" else rng.integers(0, v, (bags, hot))
    if case == "id_rule":
        ids[::3, 0], ids[1::3, 1], ids[::5, 2], ids[::7, 3] = -1, -v, v, v + 5
    table = torch.from_numpy(rng.normal(size=(v, d)).astype(np.float32)).to(cuda)
    ids = torch.from_numpy(ids.reshape(-1).astype(np.int32)).to(cuda)
    segs = torch.arange(bags, dtype=torch.int32, device=cuda).repeat_interleave(hot)
    w = torch.from_numpy(rng.random(bags * hot).astype(np.float32)).to(cuda)
    cot = torch.from_numpy(rng.normal(size=(bags, d)).astype(np.float32)).to(cuda)
    before = embedding_bag_cuda.launches
    got = _bag_grads(lambda *a: EmbeddingBagFunction.apply(*a, bags), table, ids, segs, w, cot)
    torch.cuda.synchronize()
    assert embedding_bag_cuda.launches == before + 1
    want = _bag_grads(lambda *a: embedding_bag_plain(*a, bags), table, ids, segs, w, cot)
    assert embedding_bag_cuda.launches == before + 1
    for a, b in zip(got, want):
        scale = float(b[~b.isnan()].abs().max())
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-4 * scale, equal_nan=True)
    if case == "id_rule":
        assert got[0].isnan().any() and got[2].isnan().any() and not got[1].isnan().any()


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_embedding_bag_id_rule_on_card_equals_cpu(cuda, mode):
    """jnp.take's rule on the card as on the CPU: the same NaN bags, the
    same forward and gradients, the kernel launched once in sum and mean."""
    rng = np.random.default_rng(23)
    v = 400
    table = rng.normal(size=(v, 64)).astype(np.float32)
    ids = rng.integers(0, v, 3000).astype(np.int32)
    ids[::17], ids[5::23], ids[7::29], ids[11::31], ids[13::37] = -1, -v, v, v + 5, -v - 1
    segs = rng.integers(-5, 130, 3000).astype(np.int32)
    w = rng.normal(size=3000).astype(np.float32)
    cot = rng.normal(size=(120, 64)).astype(np.float32)
    outs = []
    for dev in ("cpu", cuda):
        t = torch.from_numpy(table).to(dev).requires_grad_()
        tw = torch.from_numpy(w).to(dev).requires_grad_()
        before = embedding_bag_cuda.launches
        out = layers.embedding_bag(t, torch.from_numpy(ids).to(dev), torch.from_numpy(segs).to(dev), 120,
                                   mode=mode, weights=tw)
        out.backward(torch.from_numpy(cot).to(dev))
        assert embedding_bag_cuda.launches == before + (dev != "cpu" and mode != "max")
        outs.append([x.detach().cpu() for x in (out, t.grad, tw.grad)])
    assert outs[0][0].isnan().any() and not outs[0][0].isnan().all()
    for a, b in zip(outs[1], outs[0]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5, equal_nan=True)


def test_recsys_train_steps_on_card_equal_cpu(cuda):
    """Three AdamW ``recsys_train_step``s of the two-tower smoke config on
    the card against the CPU (tests/_torch_recsys.py's tolerances)."""
    recsys_card_equals_cpu(cuda, np.random.default_rng(3))


@pytest.mark.parametrize("chunk_rows", [2**16, 1000])
def test_inplace_adamw_on_card_is_bit_equal_to_the_functional(cuda, chunk_rows):
    """``clip_by_global_norm_`` and ``adamw_update_`` on the card against
    the functional forms on the card, from the same gradients: the same
    bits (a 70,000-row table splits into chunks at either size), the norm
    within float32 rounding of its sum's order."""
    from repro_torch._tree import tree_leaves, tree_map
    from repro_torch.optim import (
        OptimizerConfig, adamw_init, adamw_update, adamw_update_, clip_by_global_norm, clip_by_global_norm_,
    )

    g = torch.Generator(device=cuda).manual_seed(5)
    params = {"table": torch.randn(70_000, 32, device=cuda, generator=g),
              "w": torch.randn(24, 40, device=cuda, generator=g).T, "b": torch.randn(24, device=cuda, generator=g)}
    ref_params = tree_map(lambda p: p.clone(), params)
    cfg = OptimizerConfig(lr=1e-2, warmup_steps=1, decay_steps=10)
    state, ref_state = adamw_init(params), adamw_init(ref_params)
    for _ in range(3):
        grads = tree_map(lambda p: torch.randn(p.shape, device=cuda, generator=g), params)
        _, ref_norm = clip_by_global_norm(grads, 0.5)
        norm = clip_by_global_norm_(grads, 0.5, chunk_rows=chunk_rows)
        torch.testing.assert_close(norm, ref_norm, rtol=1e-6, atol=0)
        ref_params, ref_state = adamw_update(cfg, tree_map(lambda x: x.clone(), grads), ref_state, ref_params)
        state = adamw_update_(cfg, grads, state, params, chunk_rows=chunk_rows)
        for tree, ref in ((params, ref_params), (state["mu"], ref_state["mu"]), (state["nu"], ref_state["nu"])):
            assert all(torch.equal(a, b) for a, b in zip(tree_leaves(tree), tree_leaves(ref)))
    assert int(state["step"]) == 3


# ---------------------------------------------------------------------------
# the dry-run slice on the card
# ---------------------------------------------------------------------------

# float32 sums of the same terms in another order (atomics on the card):
# the reference's PageRank tolerances
ENGINE_PR_RTOL, ENGINE_PR_ATOL = 2e-4, 1e-8


def test_graph_engine_cells_on_card_equal_the_cpu(cuda, monkeypatch):
    """``pr_iteration`` and ``bfs_expand`` at RMAT scale 10 (seed 3) with
    ``V``/``E`` set to the graph's: the card's PR step within the reference's
    tolerances of the CPU's, and every BFS level equal to the CPU's up to the
    fixed point."""
    from repro_torch.configs import paper_graph_engine as engine
    from repro_torch.graph.rmat import rmat_edges

    src, dst = (torch.from_numpy(a.astype(np.int32)) for a in rmat_edges(10, seed=3))
    v = 1 << 10
    monkeypatch.setattr(engine, "V", v)
    monkeypatch.setattr(engine, "E", src.shape[0])
    pr, bfs = engine.make_cell("pr_iteration").step_fn, engine.make_cell("bfs_expand").step_fn
    rank = torch.rand(v, generator=torch.Generator().manual_seed(3))
    out_deg = torch.bincount(src, minlength=v).to(torch.int32)
    got = pr(src.to(cuda), dst.to(cuda), rank.to(cuda), out_deg.to(cuda))
    torch.testing.assert_close(got.cpu(), pr(src, dst, rank, out_deg), rtol=ENGINE_PR_RTOL, atol=ENGINE_PR_ATOL)
    visited = torch.zeros(v, dtype=torch.bool)
    visited[int(out_deg.argmax())] = True
    frontier, levels = visited.clone(), 0
    while bool(frontier.any()):
        got_vis, got_new = bfs(src.to(cuda), dst.to(cuda), visited.to(cuda), frontier.to(cuda))
        visited, frontier = bfs(src, dst, visited, frontier)
        assert torch.equal(got_vis.cpu(), visited) and torch.equal(got_new.cpu(), frontier)
        levels += 1
    assert levels > 2


def test_meta_branches_give_the_card_outputs_shapes(cuda):
    """Each kernel entry's ``meta`` branch gives the shape and type of the
    kernel's output on the card and of the plain version's on the CPU."""
    from repro_torch.kernels.attention.ops import flash_attention_gqa
    from repro_torch.kernels.degree_count.ops import count_into
    from repro_torch.kernels.embedding_bag.ops import embedding_bag
    from repro_torch.kernels.scoring.ops import score_topk
    from repro_torch.kernels.spmv.ops import build_tiles, spmv

    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 128, 4, 64, generator=g, dtype=torch.float32).to(torch.bfloat16)
    kv = torch.randn(2, 128, 2, 64, generator=g).to(torch.bfloat16)
    table, ids = torch.randn(50, 8, generator=g), torch.randint(0, 50, (30,), generator=g, dtype=torch.int32)
    segs = torch.sort(torch.randint(0, 7, (30,), generator=g, dtype=torch.int32)).values
    cands, queries = torch.randn(700, 8, generator=g), torch.randn(3, 8, generator=g)
    src = torch.randint(0, 900, (5000,), generator=g, dtype=torch.int32)
    dst = torch.randint(0, 900, (5000,), generator=g, dtype=torch.int32)
    contrib = torch.rand(900, generator=g)

    def on(dev):
        def t(x):
            return x.to(dev)

        tables = build_tiles(src.to(cuda if dev == "meta" else dev), dst.to(cuda if dev == "meta" else dev), 900)
        return [
            flash_attention_gqa(t(q), t(kv), t(kv), block_kv=64),
            embedding_bag(t(table), t(ids), t(segs), 9),
            count_into(t(src), torch.zeros(900, dtype=torch.int32, device=dev)),
            spmv(tables, t(contrib)),
            *score_topk(t(queries), t(cands), 16),
        ]

    for card, cpu, meta in zip(on(cuda), on("cpu"), on("meta")):
        assert meta.device.type == "meta" and card.device.type == "cuda"
        assert (meta.shape, meta.dtype) == (card.shape, card.dtype) == (cpu.shape, cpu.dtype)


def test_run_cell_with_the_local_mesh_on_card(cuda):
    """The dry-run on ``make_local_mesh()`` (1 × 1 over the card): every
    leaf is whole on the one chip, and the full depth's FLOPs equal the
    trip-scaled ones."""
    from repro_torch.launch.dryrun import full_depth, run_cell, scaled_totals
    from repro_torch.launch.mesh import make_local_mesh

    mesh = make_local_mesh()
    assert mesh.shape == {"data": torch.cuda.device_count(), "model": 1}
    rec = run_cell("tinyllama-1.1b", "prefill_32k", "local", analysis=True)
    mem = rec["full"]["memory"]
    assert rec["chips"] == mesh.size and rec["mesh"] == "local"
    if mesh.size == 1:
        assert mem["argument_bytes"] == mem["argument_bytes_total"] == 1_100_048_384 * 4 + 32 * 32768 * 4
    n = full_depth("tinyllama-1.1b", "prefill_32k")
    assert scaled_totals(rec, n)["flop_counter_flops_scaled"] == rec["full"]["flop_counter_flops"] > 0
