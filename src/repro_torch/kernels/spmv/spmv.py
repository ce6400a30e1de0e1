"""SpMV over ragged dst tiles: the CUDA kernel's wrapper and its plain version.

Replaces ``repro/kernels/spmv/spmv.py::spmv_pallas``. Both functions here
take one row range of the layout built by ``ops.build_tiles``: ``row_ptr``
holds int64 offsets into ``src`` (int32 source ids stably sorted by
target), and the result is the float32 vector of per-row sums
``out[r] = Σ contrib[src[i]]`` over ``i in [row_ptr[r], row_ptr[r+1])``.
The kernel walks the layout's row blocks (at most ``BLOCK_EDGES`` edges
each, long rows cut into pieces of ``BLOCK_EDGES``). The source and its
design note are ``csrc/spmv.cu``.
"""
from __future__ import annotations

import ctypes

import torch

from .._build import check, load

DST_TILE = 512       # targets per tile, as in the TPU kernel
BLOCK_EDGES = 1024   # edges per row block and per piece of a long row (kBlockEdges in csrc/spmv.cu)


def spmv_rows_plain(
    row_ptr: torch.Tensor, src: torch.Tensor, contrib: torch.Tensor, out: torch.Tensor | None = None
) -> torch.Tensor:
    """Plain PyTorch version: gather, then a segment sum per row of
    ``row_ptr`` (``R + 1`` offsets, ``[R]`` out, written into ``out`` when
    one is given)."""
    n_rows = row_ptr.shape[0] - 1
    e0, e1 = int(row_ptr[0]), int(row_ptr[-1])
    rows = torch.repeat_interleave(
        torch.arange(n_rows, device=row_ptr.device),
        row_ptr[1:] - row_ptr[:-1],
        output_size=e1 - e0,
    )
    vals = contrib[src[e0:e1].to(torch.int64)]
    if out is None:
        out = torch.zeros(n_rows, dtype=contrib.dtype, device=contrib.device)
    else:
        out.zero_()
    return out.index_add_(0, rows, vals)


def _lib() -> ctypes.CDLL:
    lib = load("spmv")
    fn = lib.spmv_blocks
    if fn.argtypes is None:  # first load: declare the C signatures
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        fn.argtypes = [p, p, p, p, p, p, p, i64, i64, i64, i64, p]
        fn.restype = ctypes.c_int
        lib.spmv_gather_probe.argtypes = [p, i64, p, p, p]
        lib.spmv_gather_probe.restype = ctypes.c_int
    return lib


def spmv_rows_cuda(
    row_ptr: torch.Tensor,
    src: torch.Tensor,
    contrib: torch.Tensor,
    blocks: torch.Tensor,
    scratch: torch.Tensor,
    *,
    block_lo: int,
    block_hi: int,
    row_base: int,
    n_rows: int,
    out: torch.Tensor | None = None,
) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream over the layout's row
    blocks ``[block_lo, block_hi)``, which must cover exactly the rows
    ``[row_base, row_base + n_rows)`` of the table. The sums go to ``out``
    when one is given (a contiguous float32 ``[n_rows]`` tensor on the
    card: every row is written), else to a new tensor.

    ``row_ptr`` (int64) and ``src`` (int32) are the whole table's;
    ``blocks`` is the layout's int32 ``[2, NB + 1]`` (first row of each
    block, with the row count after the last; then the piece index of a
    long row's block, -1 for a block of whole rows), ``scratch`` its int32
    ``[2, NB]`` (partials, then counters; zero between launches, so launches
    on one table run one after another on one stream)."""
    dev = contrib.device
    for name, t, dtype, dim in (
        ("row_ptr", row_ptr, torch.int64, 1),
        ("src", src, torch.int32, 1),
        ("contrib", contrib, torch.float32, 1),
        ("blocks", blocks, torch.int32, 2),
        ("scratch", scratch, torch.int32, 2),
    ):
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"spmv_rows_cuda: {name} must be on {dev}, got {t.device}")
        if t.dtype != dtype or t.dim() != dim or not t.is_contiguous():
            raise ValueError(
                f"spmv_rows_cuda: {name} must be a contiguous {dim}-D {dtype} tensor"
            )
    n_blocks = blocks.shape[1] - 1
    if blocks.shape[0] != 2 or scratch.shape != (2, n_blocks):
        raise ValueError("spmv_rows_cuda: blocks must be [2, NB + 1] and scratch [2, NB]")
    if not 0 <= block_lo <= block_hi <= n_blocks:
        raise ValueError(f"spmv_rows_cuda: blocks [{block_lo}, {block_hi}) outside [0, {n_blocks})")
    if out is None:
        out = torch.empty(n_rows, dtype=torch.float32, device=dev)
    elif (out.device != dev or out.dtype != torch.float32 or out.shape != (n_rows,)
          or not out.is_contiguous()):
        raise ValueError(f"spmv_rows_cuda: out must be a contiguous float32 [{n_rows}] tensor on {dev}")
    if n_rows <= 0:
        return out
    base = blocks.data_ptr()
    status = _lib().spmv_blocks(
        row_ptr.data_ptr(), src.data_ptr(), contrib.data_ptr(), out.data_ptr(),
        base, base + 4 * (n_blocks + 1), scratch.data_ptr(), n_blocks, block_lo, block_hi,
        int(row_base), torch.cuda.current_stream(dev).cuda_stream,
    )
    check(status, "spmv_blocks")
    spmv_rows_cuda.launches += 1
    return out


spmv_rows_cuda.launches = 0


def gather_probe_cuda(src: torch.Tensor, contrib: torch.Tensor) -> torch.Tensor:
    """A measuring probe, not part of any path: read every source id and
    gather its contribution as the kernel's row blocks do, with no row
    sums. Its time is the floor that the layout's gathers set."""
    for name, t, dtype in (("src", src, torch.int32), ("contrib", contrib, torch.float32)):
        if t.device.type != "cuda" or t.dtype != dtype or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"gather_probe_cuda: {name} must be a contiguous 1-D {dtype} CUDA tensor")
    n = src.shape[0]
    out = torch.empty(-(-n // BLOCK_EDGES) * 8, dtype=torch.float32, device=contrib.device)
    lib = _lib()
    check(lib.spmv_gather_probe(src.data_ptr(), n, contrib.data_ptr(), out.data_ptr(),
                                torch.cuda.current_stream(contrib.device).cuda_stream), "spmv_gather_probe")
    return out
