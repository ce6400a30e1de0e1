"""The port's CUDA kernels on the card: each against its plain PyTorch
version, and the ``cuda`` backend end to end. Every test here needs a CUDA
device and skips without one; the file imports no JAX, so it runs where
only PyTorch is installed:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import algorithms as alg  # noqa: E402
from repro_torch import core  # noqa: E402
from repro_torch.graph import rmat_graph  # noqa: E402
from repro_torch.kernels.degree_count import degree_count_cuda, degree_count_plain  # noqa: E402
from repro_torch.kernels.spmv import build_tiles, spmv_rows_cuda, spmv_rows_plain, spmv_tiles  # noqa: E402

pytestmark = pytest.mark.cuda

# f32 sums of the same positive terms in another order (warp tree vs the
# plain version's atomic adds, whose order changes from run to run): the
# relative error grows like sqrt(row length) times float32 epsilon, ~1e-5
# for the ~21k-edge hub row below, so 1e-4 (as in chip_smoke.py)
SPMV_RTOL, SPMV_ATOL = 1e-4, 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _edges(v, e, seed, targets):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, v, size=e).astype(np.int32)
    dst = rng.choice(np.asarray(targets), size=e).astype(np.int32)
    return src, dst, rng.random(v).astype(np.float32)


def test_spmv_kernel_matches_plain(cuda):
    # two hub rows past LONG_ROW (~21k and ~5.3k edges) take the
    # block-per-row pass, the rest one warp each
    src, dst, contrib = _edges(5000, 80000, 11, np.r_[0:5000, [17] * 2000, [4000] * 500])
    tables = build_tiles(torch.from_numpy(src).to(cuda), torch.from_numpy(dst).to(cuda), 5000)
    assert tables.long_rows.cpu().tolist() == [17, 4000]
    c = torch.from_numpy(contrib).to(cuda)
    for a, b in [(0, tables.n_tiles), (3, 7), (9, 10)]:
        before = spmv_rows_cuda.launches
        got = spmv_tiles(tables, c, a, b)
        again = spmv_tiles(tables, c, a, b)
        assert spmv_rows_cuda.launches == before + 2
        r0, r1 = a * 512, b * 512
        want = spmv_rows_plain(tables.row_ptr[r0 : r1 + 1], tables.src, c).reshape(b - a, 512)
        torch.testing.assert_close(got, want, rtol=SPMV_RTOL, atol=SPMV_ATOL)
        assert torch.equal(got, again)  # no float atomics: bit-repeatable


def test_spmv_slab_on_card(cuda):
    src, dst, contrib = _edges(3000, 40000, 13, np.r_[0:3000, [2100] * 900])
    tables = build_tiles(torch.from_numpy(src).to(cuda), torch.from_numpy(dst).to(cuda), 3000)
    c = torch.from_numpy(contrib).to(cuda)
    slab = tables.slab(2, 6)
    assert slab.long_rows_host.tolist() == [2100 - 2 * 512]  # a ~9k-edge hub row
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


def test_wrappers_raise_instead_of_falling_back(cuda):
    rp = torch.tensor([0, 1], dtype=torch.int64, device=cuda)
    s = torch.zeros(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="int64|int32|float32"):
        spmv_rows_cuda(rp.to(torch.int32), s, torch.zeros(1, device=cuda), s[:0], row_base=0)
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
