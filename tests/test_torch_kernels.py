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
from repro_torch.kernels.degree_count.degree_count import PRIVATE_MIN_IDS, _degree_count_path  # noqa: E402
from repro_torch.graph import rmat_edges  # noqa: E402
from repro_torch.kernels.spmv import (  # noqa: E402
    BLOCK_EDGES,
    DST_TILE,
    build_tiles,
    row_blocks,
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


@pytest.mark.parametrize("case", sorted(SPMV_CASES))
def test_spmv_tiles_writes_into_out(case):
    """With ``out`` (a view of a longer buffer at the range's own rows) the
    sums equal a fresh call's to the bit, the result views the buffer, and
    no row of the buffer outside the range is written."""
    v, e, seed, targets, ranges = SPMV_CASES[case]
    src, dst, contrib = _edges(v, e, seed, targets=targets)
    tables = build_tiles(torch.from_numpy(src), torch.from_numpy(dst), v)
    c = torch.from_numpy(contrib)
    for a, b in ranges:
        buf = torch.full((tables.n_tiles * DST_TILE,), float("nan"))
        got = spmv_tiles(tables, c, a, b, buf[a * DST_TILE : b * DST_TILE])
        assert got.data_ptr() == buf.data_ptr() + 4 * a * DST_TILE and got.shape == (b - a, DST_TILE)
        assert torch.equal(got.view(torch.int32), spmv_tiles(tables, c, a, b).view(torch.int32))
        assert torch.isnan(buf[: a * DST_TILE]).all() and torch.isnan(buf[b * DST_TILE :]).all()
        meta = torch.empty((b - a) * DST_TILE, device="meta")
        assert spmv_tiles(tables, c.to("meta"), a, b, meta).shape == (b - a, DST_TILE)


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
    # rows 1, 2 and 650 (~1.4k edges) and the hub row 3 (~5.7k) pass
    # BLOCK_EDGES and are cut into 2, 2, 2 and 6 pieces; the empty rows 0,
    # 4-511, 512-649 and 651-1023 are blocks of whole rows, one per run
    assert BLOCK_EDGES == 1024 and counts[[1, 2, 3, 650]].tolist() == [1418, 1408, 5707, 1467]
    np.testing.assert_array_equal(tables.blocks.numpy(), [
        [0, 1, 1, 2, 2, 3, 3, 3, 3, 3, 3, 4, 512, 650, 650, 651, 1024],
        [-1, 0, 1, 0, 1, 0, 1, 2, 3, 4, 5, -1, -1, 0, 1, -1, -1],
    ])
    np.testing.assert_array_equal(tables.tile_blocks, [0, 12, 16])
    assert tables.scratch.shape == (2, 16) and not tables.scratch.any()


def test_block_edges_match_kernel_source():
    """The host cuts rows into blocks of at most BLOCK_EDGES edges; the
    kernel's shared memory and its piece offsets are sized by its
    kBlockEdges. The two must agree."""
    import re
    from pathlib import Path

    import repro_torch

    cu = Path(repro_torch.__file__).parent / "csrc" / "spmv.cu"
    found = re.findall(r"constexpr int kBlockEdges = (\d+);", cu.read_text())
    assert found == [str(BLOCK_EDGES)]
    assert re.findall(r"constexpr int kTileRows = (\d+);", cu.read_text()) == [str(DST_TILE)]


def _check_partition(row_ptr, blocks, tile_blocks, block_edges):
    """Every row in exactly one block of whole rows or one long row's
    pieces; no block crosses a tile; a block of whole rows holds at most
    block_edges edges; only rows past block_edges are cut, each into
    ceil(len / block_edges) pieces 0, 1, ...; tile_blocks points at each
    tile's first block."""
    rp = row_ptr.numpy()
    rows, piece = blocks.numpy()
    n_rows = rp.shape[0] - 1
    nb = rows.shape[0] - 1
    assert rows[0] == 0 and rows[nb] == n_rows and np.all(np.diff(rows) >= 0)
    covered = np.zeros(n_rows, np.int64)
    i = 0
    while i < nb:
        r = rows[i]
        if piece[i] < 0:
            end = rows[i + 1]
            assert end > r and r // DST_TILE == (end - 1) // DST_TILE
            assert rp[end] - rp[r] <= block_edges
            covered[r:end] += 1
            i += 1
            continue
        n = rp[r + 1] - rp[r]
        k = -(-n // block_edges)
        assert n > block_edges and k >= 2
        np.testing.assert_array_equal(rows[i : i + k], r)
        np.testing.assert_array_equal(piece[i : i + k], np.arange(k))
        assert rows[i + k] == r + 1
        covered[r] += 1
        i += k
    np.testing.assert_array_equal(covered, 1)
    starts = np.searchsorted(rows[:nb], np.arange(n_rows // DST_TILE + 1) * DST_TILE)
    np.testing.assert_array_equal(np.asarray(tile_blocks), starts)


def _partition_graph(name):
    """(src, dst, V) for the partition cases."""
    rng = np.random.default_rng(len(name))
    if name == "single_edge":
        return np.array([0], np.int32), np.array([5], np.int32), 10
    if name == "empty_tiles":  # tiles 1 and 3 of 5 hold no edge
        dst = rng.choice(np.r_[0:512, 1024:1536, 2048:2200], 6000)
        return rng.integers(0, 2200, 6000).astype(np.int32), dst.astype(np.int32), 2200
    if name == "one_hub_tile":  # one tile with a 20k-edge hub, a ~3k row, and the rest sparse
        dst = np.r_[np.full(20000, 700), np.full(3000, 901), rng.integers(0, 3000, 2000)]
        return rng.integers(0, 3000, dst.shape[0]).astype(np.int32), dst.astype(np.int32), 3000
    if name == "no_edges":
        return np.zeros(0, np.int32), np.zeros(0, np.int32), 1500
    src, dst = rmat_edges(13, seed=3)  # scale-free: empty rows, hubs, medium rows
    return src.astype(np.int32), dst.astype(np.int32), 1 << 13


PARTITION_GRAPHS = ["single_edge", "empty_tiles", "one_hub_tile", "no_edges", "rmat13"]


@pytest.mark.parametrize("block_edges", [512, BLOCK_EDGES, 4096])  # the kernel's is 1024
@pytest.mark.parametrize("graph", PARTITION_GRAPHS)
def test_row_blocks_partition(graph, block_edges):
    src, dst, v = _partition_graph(graph)
    tables = build_tiles(torch.from_numpy(src), torch.from_numpy(dst), v)
    blocks, tile_blocks = row_blocks(tables.row_ptr, block_edges)
    _check_partition(tables.row_ptr, blocks, tile_blocks, block_edges)
    if block_edges == BLOCK_EDGES:  # what build_tiles cut
        assert torch.equal(blocks, tables.blocks) and np.array_equal(tile_blocks.numpy(), tables.tile_blocks)
    if graph == "one_hub_tile":  # the ~20k hub and the ~3k row in pieces, or the ~3k row whole
        assert np.count_nonzero(blocks[1].numpy() >= 0) == {512: 40 + 6, 1024: 20 + 3, 4096: 5}[block_edges]


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


def _degree_count_source() -> str:
    from pathlib import Path

    import repro_torch

    return (Path(repro_torch.__file__).parent / "csrc" / "degree_count.cu").read_text()


def _source_int(name: str) -> int:
    """The value of ``constexpr <type> name = <expression>;`` in
    csrc/degree_count.cu (integers, other such constants, ``*`` and ``<<``)."""
    import re

    found = re.findall(rf"constexpr \w+ {name} = ([^;]+);", _degree_count_source())
    assert len(found) == 1, name
    expr = found[0].replace("int64_t{1}", "1")
    for other in set(re.findall(r"\bk[A-Z]\w*", expr)):
        expr = re.sub(rf"\b{other}\b", str(_source_int(other)), expr)
    assert re.fullmatch(r"[\d\s*<]+", expr), expr
    return int(eval(expr))


def _ids_per_lane(kernel: str) -> int:
    """Ids a lane takes per warp step in the ``runs`` or ``private``
    kernel: four per 16-byte load."""
    return 4 * _source_int(f"k{kernel.title()}Vecs")


def _warp_runs(row: np.ndarray, head: int, k_ids: int):
    """(ids, lengths) of the runs the kernel's warp steps emit for one row
    whose first id sits ``head`` ids past a 16-byte boundary, in step order:
    lane-major steps of 32 lanes of ``k_ids`` positions; run starts flagged
    inside each lane and against the previous lane's last id (the shuffle
    up); a suffix min over the lanes (the shuffles down) gives each lane the
    next run start after it; each run's length runs to it."""
    step_ids = 32 * k_ids
    steps = -(-(row.shape[0] + 3) // step_ids)
    virt = np.full(steps * step_ids, -1, np.int64)
    virt[head : head + row.shape[0]] = row
    x = virt.reshape(steps, 32, k_ids)
    starts = np.empty(x.shape, bool)
    starts[:, 1:, 0] = x[:, 1:, 0] != x[:, :-1, -1]
    starts[:, 0, 0] = True
    starts[:, :, 1:] = x[:, :, 1:] != x[:, :, :-1]
    base = np.arange(32) * k_ids
    first = np.where(starts.any(2), base + starts.argmax(2), step_ids)
    suffix = np.minimum.accumulate(first[:, ::-1], axis=1)[:, ::-1]
    end = np.concatenate([suffix[:, 1:], np.full((steps, 1), step_ids)], axis=1)
    ids, lens, order = [], [], []
    for k in reversed(range(k_ids)):
        m = starts[:, :, k]
        ids.append(x[:, :, k][m])
        lens.append((end - (base + k))[m])
        order.append((np.arange(steps)[:, None] * step_ids + base + k)[m])
        end = np.where(m, base + k, end)
    o = np.argsort(np.concatenate(order), kind="stable")
    assert np.concatenate(lens).sum() == steps * step_ids  # the runs tile the steps
    return np.concatenate(ids)[o], np.concatenate(lens)[o]


def _emulate_degree_count(rows: np.ndarray, c: int, heads, log_slots: int | None = None):
    """numpy emulation of csrc/degree_count.cu on ``rows`` ([r, n] ids):
    returns (counts, global adds). ``log_slots=None`` is the runs kernel
    (one add per run of an id in [0, c)); else the private kernel with one
    block's table of 2**log_slots slots, ``kProbes`` linear probes from the
    source's multiplicative hash, overflow added straight away and one
    flush add per occupied slot."""
    counts = np.zeros(c, np.int64)
    table: dict[int, int] = {}  # slot -> id
    vals = np.zeros(1 << (log_slots or 0), np.int64)
    adds = 0
    probes = _source_int("kProbes")
    k_ids = _ids_per_lane("runs" if log_slots is None else "private")
    for row, head in zip(rows, heads):
        ids, lens = _warp_runs(row, head, k_ids)
        ok = (ids >= 0) & (ids < c)
        if log_slots is None:
            np.add.at(counts, ids[ok], lens[ok])
            adds += int(ok.sum())
            continue
        for i, n in zip(ids[ok].tolist(), lens[ok].tolist()):
            h = ((i * 2654435761) & 0xFFFFFFFF) >> (32 - log_slots)
            for _ in range(probes):
                if table.setdefault(h, i) == i:
                    vals[h] += n
                    break
                h = (h + 1) & ((1 << log_slots) - 1)
            else:
                counts[i] += n
                adds += 1
    for h, i in table.items():
        counts[i] += vals[h]
        adds += 1
    return counts.astype(np.int32), adds


def _dc_inputs(kind: str, rng) -> tuple[np.ndarray, int]:
    """[2, n] endpoint-like ids and the counter count for one input kind."""
    if kind == "sorted":  # an RMAT-like sorted src row over a skewed dst row
        src, dst = rmat_edges(12, 8, seed=5)
        order = np.argsort(src, kind="stable")
        return np.stack([src[order], dst[order]]).astype(np.int32)[:, 3000:23000], 4096
    if kind == "hub_runs":  # a package of one id, then runs of 1..700
        run = np.repeat(rng.integers(0, 3000, 60), rng.integers(1, 700, 60))
        return np.stack([np.concatenate([np.full(16384, 77), run]),
                         rng.integers(0, 3000, 16384 + run.shape[0])]).astype(np.int32), 3000
    if kind == "unsorted":
        return rng.integers(0, 5000, (2, 9001)).astype(np.int32), 5000
    if kind == "padded":  # -1 padding and ids >= C between runs
        x = np.repeat(rng.integers(-1, 2300, 900), rng.integers(1, 40, 900))
        return np.stack([x, rng.permutation(x)]).astype(np.int32), 2048
    # ids mod C, sorted before the mod: runs broken where the mod wraps
    x = np.sort(rng.integers(0, 50_000, 12_000))
    return (np.stack([x, rng.permutation(x)]) % 1009).astype(np.int32), 1009


@pytest.mark.parametrize("kind", ["sorted", "hub_runs", "unsorted", "padded", "mod_c"])
def test_degree_count_warp_runs_emulation_matches_oracles(kind):
    """The kernel's aggregation (runs inside a lane, across a warp of 32,
    then one add per run; or a per-block shared table first), emulated in
    numpy at every alignment of the row's start, equals both packages'
    oracles, and a run costs at most one add per warp step it spans."""
    ids, c = _dc_inputs(kind, np.random.default_rng(17))
    valid = ids[(ids >= 0) & (ids < c)]
    want = np.asarray(jax_degree_count_ref(jnp.asarray(ids.ravel()), c))
    np.testing.assert_array_equal(degree_count_ref(torch.from_numpy(valid), c).numpy(), want)
    n = ids.shape[1]
    runs = 1 + int(np.count_nonzero(ids[:, 1:] != ids[:, :-1], axis=1).sum()) + 1
    steps = 2 * -(-(n + 3) // (32 * _ids_per_lane("runs")))
    for heads in ((0, 0), (1, 3), (2, 1), (3, 2)):
        got, adds = _emulate_degree_count(ids, c, heads)
        np.testing.assert_array_equal(got, want)
        assert adds <= runs + steps
        got, _ = _emulate_degree_count(ids, c, heads, log_slots=6)  # a small table that overflows
        np.testing.assert_array_equal(got, want)
    if kind == "hub_runs":  # the package of one id: one add per warp step
        _, adds = _emulate_degree_count(ids[:1, :16384], c, (0,))
        assert adds == 16384 // (32 * _ids_per_lane("runs"))


def test_degree_count_constants_and_path_match_kernel_source():
    """The wrapper's kernel choice is the source's, and the source's step
    geometry is the one the emulation reads (four ids per 16-byte load)."""
    assert "static constexpr int kIdsPerLane = 4 * kVecs;" in _degree_count_source()
    assert _source_int("kPrivateMinIds") == PRIVATE_MIN_IDS
    assert "return n * rows >= kPrivateMinIds ? kPrivate : kRuns;" in _degree_count_source()
    for n, rows in ((PRIVATE_MIN_IDS, 1), (PRIVATE_MIN_IDS // 2, 2), (PRIVATE_MIN_IDS // 2 - 1, 2), (16384, 2)):
        want = "private" if n * rows >= PRIVATE_MIN_IDS else "runs"
        assert _degree_count_path(n, rows) == want


def test_cuda_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel or raises: CPU tensors never slip into
    the plain version through the CUDA entry points."""
    rp = torch.tensor([0, 1], dtype=torch.int64)
    s = torch.zeros(1, dtype=torch.int32)
    blocks = torch.tensor([[0, 1], [-1, -1]], dtype=torch.int32)
    with pytest.raises(ValueError, match="must be on"):
        spmv_rows_cuda(rp, s, torch.zeros(1), blocks, torch.zeros(2, 1, dtype=torch.int32),
                       block_lo=0, block_hi=1, row_base=0, n_rows=1)
    with pytest.raises(ValueError, match="must be on"):
        degree_count_cuda(s, torch.zeros(4, dtype=torch.int32))
