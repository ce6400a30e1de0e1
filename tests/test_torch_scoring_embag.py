"""The port's scoring and EmbeddingBag kernels (plain versions, on the CPU)
against the JAX package's Pallas kernels in interpret mode, on the same
inputs, and the tensor-core scoring kernel's 3xTF32 arithmetic emulated in
numpy. The CUDA kernels are held against these plain versions in
test_torch_cuda.py."""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.kernels.embedding_bag import embedding_bag as jax_embedding_bag  # noqa: E402
from repro.kernels.scoring import scoring_pallas  # noqa: E402
from repro.kernels.scoring import score_topk as jax_score_topk  # noqa: E402
from repro.layers import embedding as jax_layers  # noqa: E402
from repro_torch.kernels.embedding_bag import (  # noqa: E402
    embedding_bag,
    embedding_bag_cuda,
    embedding_bag_plain,
    embedding_bag_ref,
)
from repro_torch.layers import embedding as torch_layers  # noqa: E402
from repro_torch.kernels.scoring import (  # noqa: E402
    CAND_TILE,
    NEG,
    score_topk,
    scoring_cuda,
    scoring_plain,
    scoring_ref,
    topk_ref,
)
from repro_torch.kernels.scoring.scoring import STREAM_MAX_BATCH, _scoring_path  # noqa: E402

# the JAX package's tolerances (tests/test_kernels.py): scoring 1e-5; a sum
# of weighted rows 1e-4 / 1e-5, plain sums 1e-5
SCORE_TOL = 1e-5
BAG_RTOL, BAG_ATOL = 1e-5, 1e-5
WBAG_RTOL, WBAG_ATOL = 1e-4, 1e-5

# the shapes of tests/test_kernels.py::test_scoring_topk, plus N < CAND_TILE
SCORING_SHAPES = [(1, 4096, 64), (4, 5000, 32), (8, 2048, 128), (2, 1000, 16)]


def _qc(b, n, d, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(b, d)).astype(np.float32), rng.normal(size=(n, d)).astype(np.float32)


@pytest.mark.parametrize("b,n,d", SCORING_SHAPES)
def test_scoring_plain_matches_pallas(b, n, d):
    q, c = _qc(b, n, d, b + n + d)
    n_pad = -(-n // CAND_TILE) * CAND_TILE
    c = np.pad(c, ((0, n_pad - n), (0, 0)))  # the Pallas kernel takes whole tiles
    want = np.asarray(scoring_pallas(jnp.asarray(q), jnp.asarray(c), interpret=True))
    got = scoring_plain(torch.from_numpy(q), torch.from_numpy(c)).numpy()
    np.testing.assert_allclose(got, want, rtol=SCORE_TOL, atol=SCORE_TOL)


@pytest.mark.parametrize("b,n,d", SCORING_SHAPES)
def test_score_topk_matches_jax(b, n, d):
    q, c = _qc(b, n, d, 7 * b + n + d)
    jv, ji = jax_score_topk(jnp.asarray(q), jnp.asarray(c), k=16)
    tq, tc = torch.from_numpy(q), torch.from_numpy(c)
    before = scoring_cuda.launches
    v, i = score_topk(tq, tc, 16)
    assert scoring_cuda.launches == before  # a CPU tensor takes the plain version
    assert v.shape == i.shape == (b, 16) and i.dtype == torch.int64
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=SCORE_TOL, atol=SCORE_TOL)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    rv, ri = topk_ref(tq, tc, 16)
    torch.testing.assert_close(v, rv, rtol=SCORE_TOL, atol=SCORE_TOL)


def test_score_topk_orders_equal_scores_by_position():
    """Repeated candidates score equally; like ``lax.top_k`` the lower
    index comes first, across tiles and at the cut."""
    rng = np.random.default_rng(3)
    base = rng.normal(size=(300, 8)).astype(np.float32)
    c = base[rng.integers(0, 300, 5000)]  # every candidate repeated ~17 times
    q = rng.normal(size=(3, 8)).astype(np.float32)
    jv, ji = jax_score_topk(jnp.asarray(q), jnp.asarray(c), k=40)
    v, i = score_topk(torch.from_numpy(q), torch.from_numpy(c), 40)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=SCORE_TOL, atol=SCORE_TOL)


def test_score_topk_never_returns_padding():
    q, c = _qc(2, 100, 4, 1)
    v, i = score_topk(torch.from_numpy(q), torch.from_numpy(c), 100)
    assert int(i.max()) < 100 and float(v.min()) > NEG
    torch.testing.assert_close(v, torch.sort(scoring_ref(torch.from_numpy(q), torch.from_numpy(c)),
                                             descending=True).values)


def test_scoring_cuda_raises_on_cpu_tensors():
    q, c = _qc(2, 2048, 8, 2)
    with pytest.raises(ValueError, match="must be on"):
        scoring_cuda(torch.from_numpy(q), torch.from_numpy(c))


# ---- the tensor-core kernel's arithmetic (csrc/scoring.cu, scoring_tc_kernel) ----

def _tf32(x):
    """``cvt.rna.tf32.f32``: round to 10 mantissa bits, to nearest, ties
    away from zero (add half of the dropped part to the bit pattern, then
    clear the low 13 bits)."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32((x - hi).astype(np.float32))


def _exact(a, b):  # products of tf32 values are exact in float32; sum in float64
    return a.astype(np.float64) @ b.astype(np.float64).T


def _scores_3xtf32(q, c):
    """scores = (C_hi·Q_hi + C_hi·Q_lo + C_lo·Q_hi)ᵀ, candidates as A and
    queries as B, as the kernel issues its three products."""
    (qh, ql), (ch, cl) = _split(q), _split(c)
    return (_exact(ch, qh) + _exact(ch, ql) + _exact(cl, qh)).T.astype(np.float32)


def _unit_rows(rng, n, d, scaled):
    x = rng.normal(size=(n, d))
    x /= np.linalg.norm(x, axis=-1, keepdims=True)
    # scaled: non-negative rows times 10^3, scores ~6e5 without cancellation,
    # so the tolerance's relative part is what holds them
    return (np.abs(x) * 1e3 if scaled else x).astype(np.float32)


def _tc_case(scaled):
    rng = np.random.default_rng(15)
    q, c = _unit_rows(rng, 64, 256, scaled), _unit_rows(rng, 2048, 256, scaled)
    want = np.asarray(scoring_pallas(jnp.asarray(q), jnp.asarray(c), interpret=True))
    return q, c, want


@pytest.mark.parametrize("scaled", [False, True], ids=["unit", "scaled_1e3"])
def test_3xtf32_split_matches_pallas(scaled):
    q, c, want = _tc_case(scaled)
    np.testing.assert_allclose(_scores_3xtf32(q, c), want, rtol=SCORE_TOL, atol=SCORE_TOL)


@pytest.mark.parametrize("scaled", [False, True], ids=["unit", "scaled_1e3"])
def test_single_tf32_product_misses_the_tolerance(scaled):
    """Why the kernel splits: one TF32 product, even rounded to nearest
    (wgmma alone would truncate), moves most scores past 1e-5."""
    q, c, want = _tc_case(scaled)
    got = _exact(_tf32(q), _tf32(c)).astype(np.float32)
    outside = np.abs(got - want) > SCORE_TOL + SCORE_TOL * np.abs(want)
    assert outside.mean() > 0.1


@pytest.mark.parametrize("b,d,path", [
    (1, 256, "stream"), (2, 256, "stream"), (STREAM_MAX_BATCH, 256, "stream"),
    (STREAM_MAX_BATCH + 1, 256, "tc"), (16, 256, "tc"), (64, 256, "tc"), (512, 256, "tc"),
    (64, 16, "tc"), (512, 37, "stream"), (70, 6, "stream"),
])
def test_scoring_path_rule(b, d, path):
    """Small batches stream on the CUDA cores; larger ones take the tensor
    cores where TMA can load the rows (D % 4 == 0)."""
    assert _scoring_path(b, d) == path


def test_stream_limit_matches_the_source():
    src = (Path(__file__).resolve().parents[1] / "src/repro_torch/csrc/scoring.cu").read_text()
    assert re.search(r"constexpr int kStreamMaxBatch = (\d+);", src).group(1) == str(STREAM_MAX_BATCH)


def _bag_case(v, d, n, b, seed):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(v, d)).astype(np.float32)
    ids = rng.integers(0, v, n).astype(np.int32)
    segs = rng.integers(0, b, n).astype(np.int32)
    w = rng.normal(size=n).astype(np.float32)
    return table, ids, segs, w


def _both(table, ids, segs, b, w=None):
    jw = None if w is None else jnp.asarray(w)
    want = np.asarray(jax_embedding_bag(jnp.asarray(table), jnp.asarray(ids), jnp.asarray(segs), b,
                                        weights=jw))
    tw = None if w is None else torch.from_numpy(w)
    before = embedding_bag_cuda.launches
    got = embedding_bag(torch.from_numpy(table), torch.from_numpy(ids), torch.from_numpy(segs), b,
                        weights=tw)
    assert embedding_bag_cuda.launches == before  # a CPU table takes the plain version
    return want, got.numpy()


# the shapes of tests/test_kernels.py::test_embedding_bag_shapes
@pytest.mark.parametrize("v,d,n,b", [(500, 32, 200, 16), (100, 8, 50, 7), (1000, 64, 400, 32)])
def test_embedding_bag_matches_jax(v, d, n, b):
    table, ids, segs, _ = _bag_case(v, d, n, b, v + n)
    want, got = _both(table, ids, segs, b)
    np.testing.assert_allclose(got, want, rtol=BAG_RTOL, atol=BAG_ATOL)
    ref = embedding_bag_ref(torch.from_numpy(table), torch.from_numpy(ids), torch.from_numpy(segs),
                            torch.ones(n), b)
    np.testing.assert_allclose(got, ref.numpy(), rtol=BAG_RTOL, atol=BAG_ATOL)


BAG_CASES = {
    # name: (table rows, D, ids, segments, bags, weighted)
    "empty_bags": (50, 8, [1, 2, 9], [0, 0, 3], 6, False),
    "unsorted_segments": (60, 16, [5, 1, 7, 3, 2, 9, 4], [4, 0, 2, 0, 4, 1, 2], 5, False),
    "repeated_ids": (40, 8, [3, 3, 3, 7, 3, 7], [0, 0, 1, 1, 2, 2], 3, False),
    "weighted_with_zero_weights": (80, 16, [1, 5, 5, 9, 2, 0], [0, 0, 1, 1, 1, 3], 4, True),
    "weighted_unsorted": (200, 16, None, None, 8, True),  # random, as test_kernels.py:96
}


@pytest.mark.parametrize("case", list(BAG_CASES))
def test_embedding_bag_cases_match_jax(case):
    v, d, ids, segs, b, weighted = BAG_CASES[case]
    table, rids, rsegs, w = _bag_case(v, d, 64, b, len(case))
    ids = rids if ids is None else np.asarray(ids, np.int32)
    segs = rsegs if segs is None else np.asarray(segs, np.int32)
    w = w[: len(ids)].copy() if weighted else None
    if case == "weighted_with_zero_weights":
        w[[1, 3]] = 0.0  # the fixed hot-size's padding
    want, got = _both(table, ids, segs, b, w)
    rtol, atol = (WBAG_RTOL, WBAG_ATOL) if weighted else (BAG_RTOL, BAG_ATOL)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)
    empty = np.setdiff1d(np.arange(b), segs)
    assert not got[empty].any()  # bags with no ids are zeros


def test_embedding_bag_cuda_raises_on_cpu_tensors():
    t = torch.zeros(4, 2)
    i = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="must be on"):
        embedding_bag_cuda(t, i, i, None, 2)


# ids whose segment lies outside [0, num_bags) fall in no bag, as
# jax.ops.segment_sum and segment_max drop them: segments from the seed
# over [lo, hi) against num_bags bags
OUT_OF_RANGE = {
    # name: (lo, hi, bags)
    "negative": (-4, 9, 9),
    "past_num_bags": (0, 14, 9),
    "both_sides_and_empty_bags": (-3, 40, 30),   # ~200 ids over 43 values: bags left empty
    "all_outside": (9, 20, 9),
}
# the reference's float32 sums in another order; max picks one of the rows
OOR_RTOL, OOR_ATOL = 1e-5, 1e-6


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
@pytest.mark.parametrize("case", list(OUT_OF_RANGE))
def test_embedding_bag_drops_out_of_range_segments(case, mode, weighted):
    lo, hi, b = OUT_OF_RANGE[case]
    rng = np.random.default_rng(len(case) * 7 + len(mode))
    table = rng.normal(size=(300, 16)).astype(np.float32)
    ids = rng.integers(0, 300, 200).astype(np.int32)
    segs = rng.integers(lo, hi, 200).astype(np.int32)
    w = rng.normal(size=200).astype(np.float32) if weighted else None
    if weighted:
        w[::5] = 0.0  # weight-0 ids still count in the mean
    want = np.asarray(jax_layers.embedding_bag(
        jnp.asarray(table), jnp.asarray(ids), jnp.asarray(segs), b, mode=mode,
        weights=None if w is None else jnp.asarray(w)))
    got = torch_layers.embedding_bag(
        torch.from_numpy(table), torch.from_numpy(ids), torch.from_numpy(segs), b, mode=mode,
        weights=None if w is None else torch.from_numpy(w)).numpy()
    assert got.shape == want.shape == (b, 16)
    if mode == "max":
        np.testing.assert_array_equal(got, want)  # empty bags -inf in both
    else:
        np.testing.assert_allclose(got, want, rtol=OOR_RTOL, atol=OOR_ATOL)
    if mode == "sum":  # the plain version and the oracle drop them too
        args = [torch.from_numpy(a) for a in (table, ids, segs)]
        ones = torch.ones(200) if w is None else torch.from_numpy(w)
        plain = embedding_bag_plain(*args, None if w is None else ones, b)
        np.testing.assert_allclose(plain.numpy(), want, rtol=OOR_RTOL, atol=OOR_ATOL)
        np.testing.assert_allclose(embedding_bag_ref(*args, ones, b).numpy(), want, rtol=OOR_RTOL, atol=OOR_ATOL)
