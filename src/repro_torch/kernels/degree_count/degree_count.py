"""Degree count (vertex-id histogram): the CUDA kernel's wrapper and its
plain version.

Replaces ``repro/kernels/degree_count/degree_count.py::degree_count_pallas``.
Both functions add into a caller-zeroed int32 ``counts`` array the number of
times each id in ``[0, len(counts))`` occurs in ``ids``; any other id (the -1
padding) is never counted. ``ids`` is int32, 1-D, or 2-D with contiguous
rows (the backend passes a ``[2, n]`` column slice of its endpoint table).
On the card one of two kernels runs, by :func:`_degree_count_path`: both
add up runs of equal neighbouring ids in a warp before one atomic per run;
the ``"runs"`` kernel adds them into the global counters, the ``"private"``
kernel (large launches) into a per-block table in shared memory first. The
source and its design note are ``csrc/degree_count.cu``.
"""
from __future__ import annotations

import ctypes

import torch

from .._build import check, load

# from this many ids a launch (rows x n) the private kernel runs: where it
# overtakes the runs kernel on the H100 (tools/degree_count_ab.py);
# csrc/degree_count.cu states the same (kPrivateMinIds)
PRIVATE_MIN_IDS = 1 << 22
_PATHS = {"runs": 0, "private": 1}


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


def _degree_count_path(n: int, rows: int) -> str:
    """Which kernel counts ``rows`` rows of ``n`` ids: ``"private"`` from
    ``PRIVATE_MIN_IDS`` ids, where the shared-memory table's flush is small
    against the ids, else ``"runs"``."""
    return "private" if n * rows >= PRIVATE_MIN_IDS else "runs"


def _lib() -> ctypes.CDLL:
    lib = load("degree_count")
    if lib.degree_count.argtypes is None:  # first load: declare the C signatures
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
        lib.degree_count.argtypes = [p, i64, i64, i64, p, i32, p]
        lib.degree_count.restype = ctypes.c_int
        lib.degree_count_variant.argtypes = [p, i64, i64, i64, p, i32, ctypes.c_int, i64, p]
        lib.degree_count_variant.restype = ctypes.c_int
        lib.degree_count_path.argtypes = [i64, i64]
        lib.degree_count_path.restype = ctypes.c_int
        for n in (PRIVATE_MIN_IDS - 1, PRIVATE_MIN_IDS):
            if lib.degree_count_path(n, 1) != _PATHS[_degree_count_path(n, 1)]:
                raise RuntimeError("csrc/degree_count.cu and degree_count.py choose kernels differently")
    return lib


def _launch(ids: torch.Tensor, counts: torch.Tensor, path: str | None = None, max_blocks: int = 0) -> torch.Tensor:
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
    path = path or _degree_count_path(n, rows)
    args = (ids.data_ptr(), n, rows, row_stride, counts.data_ptr(), counts.shape[0])
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _lib()
    if max_blocks or path != _degree_count_path(n, rows):
        status = lib.degree_count_variant(*args, _PATHS[path], max_blocks, stream)
    else:
        status = lib.degree_count(*args, stream)
    check(status, f"degree_count ({path})")
    degree_count_cuda.launches += 1
    degree_count_cuda.launches_by_path[path] += 1
    return counts


def degree_count_cuda(ids: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Launch the kernel that :func:`_degree_count_path` names on the
    current stream; adds into ``counts``."""
    return _launch(ids, counts)


def _degree_count_variant(ids: torch.Tensor, counts: torch.Tensor, path: str, max_blocks: int = 0) -> torch.Tensor:
    """One kernel of the caller's choosing, its grid cut to at most
    ``max_blocks`` blocks (0: the kernel's own grid), for the tests and
    ``tools/degree_count_ab.py``; the backend calls :func:`degree_count_cuda`."""
    if path not in _PATHS or max_blocks < 0:
        raise ValueError(f"degree_count variant: unknown path {path!r} or block cap {max_blocks}")
    return _launch(ids, counts, path, max_blocks)


degree_count_cuda.launches = 0
degree_count_cuda.launches_by_path = {"runs": 0, "private": 0}
