"""Degree count (vertex-id histogram): the CUDA kernel's wrapper and its
plain version.

Replaces ``repro/kernels/degree_count/degree_count.py::degree_count_pallas``.
Both functions add into a caller-zeroed int32 ``counts`` array the number of
times each id in ``[0, len(counts))`` occurs in ``ids``; any other id (the -1
padding) is never counted. ``ids`` is int32, 1-D, or 2-D with contiguous
rows (the backend passes a ``[2, n]`` column slice of its endpoint table).
The source and its design note are ``csrc/degree_count.cu``.
"""
from __future__ import annotations

import ctypes

import torch

from .._build import check, load


def degree_count_plain(ids: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``index_add_`` of ones, out-of-range ids sent
    to a discarded pad counter."""
    c = counts.shape[0]
    flat = ids.reshape(-1).to(torch.int64)
    idx = torch.where((flat >= 0) & (flat < c), flat, c)
    buf = torch.zeros(c + 1, dtype=torch.int32, device=counts.device)
    buf.index_add_(0, idx, torch.ones_like(idx, dtype=torch.int32))
    counts += buf[:c]
    return counts


def _lib() -> ctypes.CDLL:
    lib = load("degree_count")
    fn = lib.degree_count
    if fn.argtypes is None:  # first load: declare the C signature
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        fn.argtypes = [p, i64, i64, i64, p, ctypes.c_int32, p]
        fn.restype = ctypes.c_int
    return lib


def degree_count_cuda(ids: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream; adds into ``counts``."""
    dev = counts.device
    for name, t in (("ids", ids), ("counts", counts)):
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"degree_count_cuda: {name} must be on {dev}, got {t.device}")
        if t.dtype != torch.int32:
            raise ValueError(f"degree_count_cuda: {name} must be int32, got {t.dtype}")
    if counts.dim() != 1 or not counts.is_contiguous():
        raise ValueError("degree_count_cuda: counts must be a contiguous 1-D tensor")
    if counts.shape[0] >= 2**31:
        raise ValueError("degree_count_cuda: at most 2**31 - 1 counters")
    if ids.dim() == 1:
        rows, n, row_stride = 1, ids.shape[0], ids.shape[0]
    elif ids.dim() == 2:
        rows, n, row_stride = ids.shape[0], ids.shape[1], ids.stride(0)
    else:
        raise ValueError("degree_count_cuda: ids must be 1-D or 2-D")
    if n > 1 and ids.stride(-1) != 1:
        raise ValueError("degree_count_cuda: ids rows must be contiguous")
    if n == 0 or rows == 0:
        return counts
    lib = _lib()
    status = lib.degree_count(
        ids.data_ptr(), n, rows, row_stride, counts.data_ptr(), counts.shape[0],
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check(status, "degree_count")
    degree_count_cuda.launches += 1
    return counts


degree_count_cuda.launches = 0
