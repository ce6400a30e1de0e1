"""The port's kernels (plain versions, on the CPU) against the JAX
package's Pallas kernels in interpret mode, on the same inputs. The CUDA
kernels are held against these plain versions in test_torch_cuda.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from repro.kernels.degree_count import degree_count as jax_degree_count  # noqa: E402
from repro.kernels.degree_count import degree_count_ref as jax_degree_count_ref  # noqa: E402
from repro.kernels.spmv import build_tiles as jax_build_tiles  # noqa: E402
from repro.kernels.spmv import spmv_pallas  # noqa: E402
from repro_torch.kernels.degree_count import (  # noqa: E402
    count_into,
    degree_count,
    degree_count_cuda,
    degree_count_ref,
)
from repro_torch.kernels.spmv import (  # noqa: E402
    LONG_ROW,
    build_tiles,
    spmv,
    spmv_ref,
    spmv_rows_cuda,
    spmv_tiles,
)

# f32 sums of the same terms in another order (one-hot matmul vs segment sum)
SPMV_RTOL, SPMV_ATOL = 1e-5, 1e-6


def _edges(v, e, seed, *, targets=None):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, v, size=e).astype(np.int32)
    if targets is None:
        dst = rng.integers(0, v, size=e).astype(np.int32)
    else:
        dst = rng.choice(np.asarray(targets), size=e).astype(np.int32)
    contrib = rng.random(v).astype(np.float32)
    return src, dst, contrib


def _both(src, dst, contrib, v, a, b):
    js, jd, _ = jax_build_tiles(src, dst, v)
    want = np.asarray(spmv_pallas(js[a:b], jd[a:b], jnp.asarray(contrib), interpret=True))
    tables = build_tiles(torch.from_numpy(src), torch.from_numpy(dst), v)
    got = spmv_tiles(tables, torch.from_numpy(contrib), a, b).numpy()
    return want, got


SPMV_CASES = {
    # name: (V, E, seed, targets, tile ranges)
    "one_partial_tile": (100, 500, 1, None, [(0, 1)]),
    "v_not_multiple": (1300, 9000, 2, None, [(0, 3), (0, 1), (1, 3), (2, 3)]),
    "empty_tiles": (2048, 3000, 3, [5, 7, 600, 1100, 1101], [(0, 4), (1, 2), (3, 4)]),
    "hub_rows": (700, 10000, 4, [3, 3, 3, 3, 650, 1, 2], [(0, 2), (1, 2)]),
}


@pytest.mark.parametrize("case", sorted(SPMV_CASES))
def test_spmv_matches_pallas(case):
    v, e, seed, targets, ranges = SPMV_CASES[case]
    src, dst, contrib = _edges(v, e, seed, targets=targets)
    for a, b in ranges:
        want, got = _both(src, dst, contrib, v, a, b)
        assert got.shape == want.shape == (b - a, 512)
        np.testing.assert_allclose(got, want, rtol=SPMV_RTOL, atol=SPMV_ATOL)
        # targets past the last vertex and empty rows come out exactly 0
        np.testing.assert_array_equal(got[want == 0], 0.0)


def test_spmv_matches_coo_oracle():
    src, dst, contrib = _edges(1300, 9000, 6)
    tables = build_tiles(torch.from_numpy(src), torch.from_numpy(dst), 1300)
    got = spmv(tables, torch.from_numpy(contrib))
    want = spmv_ref(torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(contrib), 1300)
    assert got.shape == (1300,)
    torch.testing.assert_close(got, want, rtol=SPMV_RTOL, atol=SPMV_ATOL)


def test_build_tiles_layout():
    src, dst, _ = _edges(700, 10000, 4, targets=[3, 3, 3, 3, 650, 1, 2])
    tables = build_tiles(torch.from_numpy(src), torch.from_numpy(dst), 700)
    counts = np.bincount(dst, minlength=1024)
    assert tables.n_tiles == 2 and tables.row_ptr.dtype == torch.int64
    np.testing.assert_array_equal(tables.row_ptr.numpy(), np.concatenate([[0], np.cumsum(counts)]))
    # stable sort by target keeps each row's edges in input order
    np.testing.assert_array_equal(tables.src.numpy(), src[np.argsort(dst, kind="stable")])
    # row 3 holds ~4/7 of the edges: the one hub row past LONG_ROW
    np.testing.assert_array_equal(tables.long_rows_host, np.nonzero(counts > LONG_ROW)[0])
    np.testing.assert_array_equal(tables.long_rows_host, [3])
    np.testing.assert_array_equal(tables.long_rows.numpy(), tables.long_rows_host)


def test_spmv_slab_matches_full_tables():
    src, dst, contrib = _edges(2000, 12000, 7, targets=np.r_[0:2000, [1500] * 2000])
    tables = build_tiles(torch.from_numpy(src), torch.from_numpy(dst), 2000)
    slab = tables.slab(1, 3)
    assert slab.row_ptr[0] == 0 and slab.src.shape[0] == int(slab.row_ptr[-1])
    c = torch.from_numpy(contrib)
    torch.testing.assert_close(spmv_tiles(slab, c, 0, 2), spmv_tiles(tables, c, 1, 3), rtol=0, atol=0)
    assert (slab.long_rows_host == np.array([1500 - 512])).all()


def test_long_row_threshold_matches_kernel_source():
    """The host lists the rows past LONG_ROW; the kernel leaves exactly the
    rows past its kLongRow to the block-per-row pass. The two must agree."""
    import re
    from pathlib import Path

    import repro_torch

    cu = Path(repro_torch.__file__).parent / "csrc" / "spmv.cu"
    found = re.findall(r"constexpr int64_t kLongRow = (\d+);", cu.read_text())
    assert found == [str(LONG_ROW)]


@pytest.mark.parametrize("num_counters", [2048, 4096, 1000, 3001])
def test_degree_count_matches_jax(num_counters):
    rng = np.random.default_rng(num_counters)
    src = rng.integers(0, 5000, size=7000).astype(np.int32)
    dst = rng.integers(0, 5000, size=7000).astype(np.int32)
    want = np.asarray(
        jax_degree_count(jnp.asarray(src), jnp.asarray(dst), num_counters, interpret=True)
    )
    got = degree_count(torch.from_numpy(src), torch.from_numpy(dst), num_counters)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_degree_count_skips_padding_and_accumulates():
    rng = np.random.default_rng(9)
    ids = rng.integers(-1, 3000, size=9000).astype(np.int32)  # -1 pad, some ≥ C
    want = np.asarray(jax_degree_count_ref(jnp.asarray(ids), 2048))
    got = torch.zeros(2048, dtype=torch.int32)
    count_into(torch.from_numpy(ids[:4000]), got)
    count_into(torch.from_numpy(ids[4000:]), got)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        degree_count_ref(torch.from_numpy(ids[ids < 2048]), 2048).numpy(), want
    )


def test_degree_count_two_row_column_slice():
    """The backend passes a [2, n] column slice of its endpoint table."""
    rng = np.random.default_rng(10)
    table = torch.from_numpy(rng.integers(0, 500, size=(2, 3000)).astype(np.int32))
    got = count_into(table[:, 700:2100], torch.zeros(500, dtype=torch.int32))
    want = np.bincount(table[:, 700:2100].numpy().ravel(), minlength=500)
    np.testing.assert_array_equal(got.numpy(), want)


def test_cuda_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel or raises: CPU tensors never slip into
    the plain version through the CUDA entry points."""
    rp = torch.tensor([0, 1], dtype=torch.int64)
    s = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="must be on"):
        spmv_rows_cuda(rp, s, torch.zeros(1), s[:0], row_base=0)
    with pytest.raises(ValueError, match="must be on"):
        degree_count_cuda(s, torch.zeros(4, dtype=torch.int32))
