"""SpMV over ragged dst tiles: the CUDA kernel's wrapper and its plain version.

Replaces ``repro/kernels/spmv/spmv.py::spmv_pallas``. Both functions here
take one row range of the layout built by ``ops.build_tiles``: ``row_ptr``
holds ``R + 1`` int64 offsets into ``src`` (int32 source ids stably sorted by
target), and the result is the ``[R]`` float32 vector of per-row sums
``out[r] = Σ contrib[src[i]]`` over ``i in [row_ptr[r], row_ptr[r+1])``.
The source and its design note are ``csrc/spmv.cu``.
"""
from __future__ import annotations

import ctypes

import torch

from .._build import check, load

DST_TILE = 512   # targets per tile, as in the TPU kernel
LONG_ROW = 4096  # rows with more edges get a whole CUDA block each (kLongRow in csrc/spmv.cu)


def spmv_rows_plain(row_ptr: torch.Tensor, src: torch.Tensor, contrib: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: gather, then a segment sum per row."""
    n_rows = row_ptr.shape[0] - 1
    e0, e1 = int(row_ptr[0]), int(row_ptr[-1])
    rows = torch.repeat_interleave(
        torch.arange(n_rows, device=row_ptr.device),
        row_ptr[1:] - row_ptr[:-1],
        output_size=e1 - e0,
    )
    vals = contrib[src[e0:e1].to(torch.int64)]
    out = torch.zeros(n_rows, dtype=contrib.dtype, device=contrib.device)
    return out.index_add_(0, rows, vals)


def _lib() -> ctypes.CDLL:
    lib = load("spmv")
    fn = lib.spmv_rows
    if fn.argtypes is None:  # first load: declare the C signature
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        fn.argtypes = [p, i64, p, p, p, p, i64, i64, p]
        fn.restype = ctypes.c_int
    return lib


def spmv_rows_cuda(
    row_ptr: torch.Tensor,
    src: torch.Tensor,
    contrib: torch.Tensor,
    long_rows: torch.Tensor,
    *,
    row_base: int,
) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream.

    ``long_rows`` (int32, ascending) lists as ``row_base + r`` exactly the
    rows ``r`` of this range with more than ``LONG_ROW`` edges."""
    dev = contrib.device
    for name, t, dtype in (
        ("row_ptr", row_ptr, torch.int64),
        ("src", src, torch.int32),
        ("contrib", contrib, torch.float32),
        ("long_rows", long_rows, torch.int32),
    ):
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"spmv_rows_cuda: {name} must be on {dev}, got {t.device}")
        if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(
                f"spmv_rows_cuda: {name} must be a contiguous 1-D {dtype} tensor"
            )
    n_rows = row_ptr.shape[0] - 1
    out = torch.empty(n_rows, dtype=torch.float32, device=dev)
    if n_rows <= 0:
        return out
    lib = _lib()
    status = lib.spmv_rows(
        row_ptr.data_ptr(), n_rows, src.data_ptr(), contrib.data_ptr(), out.data_ptr(),
        long_rows.data_ptr(), long_rows.shape[0], int(row_base),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check(status, "spmv_rows")
    spmv_rows_cuda.launches += 1
    return out


spmv_rows_cuda.launches = 0
