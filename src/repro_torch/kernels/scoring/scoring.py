"""Candidate scoring: the CUDA kernels' wrapper and their plain version.

Replaces ``repro/kernels/scoring/scoring.py::scoring_pallas``. Both
functions take float32 ``queries [B, D]`` and ``candidates [N, D]`` and
return the float32 scores ``[B, N] = queries @ candidates.T``, held to the
JAX package's 1e-5. On the card one of two kernels runs, by
:func:`_scoring_path`: a streaming kernel on the CUDA cores for small
batches (exact float32 FMAs), or a tensor-core kernel on the 3xTF32 split
for larger ones. The source and its design note are ``csrc/scoring.cu``.
"""
from __future__ import annotations

import ctypes

import torch

from .._build import check, load

CAND_TILE = 2048     # candidates per tile, as in the TPU kernel; N is padded to it
# the largest batch the streaming kernel takes when the tensor-core kernel
# could (D % 4 == 0): where the two cross on the H100 at the retrieval
# server's shapes (tools/scoring_ab.py); csrc/scoring.cu states the same
STREAM_MAX_BATCH = 4
_MAX_BATCH = 2**31 - 1  # query rows are 32-bit TMA coordinates; both grids loop
# a chunk of queries sits in 96 KB of shared memory: one query of this depth
_MAX_STREAM_DEPTH = 96 * 1024 // 4
_PATHS = {"stream": 0, "tc": 1}


def scoring_plain(queries: torch.Tensor, candidates: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: one float32 matrix product."""
    return queries @ candidates.T


def _scoring_path(b: int, d: int) -> str:
    """Which kernel scores ``b`` queries of depth ``d``: ``"tc"`` (tensor
    cores, 3xTF32) past ``STREAM_MAX_BATCH`` queries when ``d % 4 == 0``
    (TMA's 16-byte row strides), else ``"stream"`` (CUDA cores)."""
    return "tc" if b > STREAM_MAX_BATCH and d % 4 == 0 else "stream"


def _lib() -> ctypes.CDLL:
    lib = load("scoring")
    if lib.scoring.argtypes is None:  # first load: declare the C signatures
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.scoring.argtypes = [p, p, p, p, i64, i64, i64, p]
        lib.scoring.restype = i32
        lib.scoring_variant.argtypes = [p, p, p, p, i64, i64, i64, i32, i32, p]
        lib.scoring_variant.restype = i32
        lib.scoring_stream_max_batch.argtypes = []
        lib.scoring_stream_max_batch.restype = i32
        if lib.scoring_stream_max_batch() != STREAM_MAX_BATCH:
            raise RuntimeError("csrc/scoring.cu and scoring.py state different stream batch limits")
    return lib


def _launch(queries: torch.Tensor, candidates: torch.Tensor, path: str | None = None,
            width: int = 0) -> torch.Tensor:
    dev = candidates.device
    for name, t in (("queries", queries), ("candidates", candidates)):
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"scoring_cuda: {name} must be on {dev}, got {t.device}")
        if t.dtype != torch.float32 or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"scoring_cuda: {name} must be a contiguous 2-D float32 tensor")
    (b, d), (n, d2) = queries.shape, candidates.shape
    if d != d2 or d == 0:
        raise ValueError(f"scoring_cuda: depth mismatch or empty, queries {d} candidates {d2}")
    if n % CAND_TILE != 0:
        raise ValueError(f"scoring_cuda: {n} candidates is not a multiple of {CAND_TILE}")
    if b > _MAX_BATCH:
        raise ValueError(f"scoring_cuda: at most {_MAX_BATCH} queries per call")
    path = path or _scoring_path(b, d)
    if path == "stream" and d > _MAX_STREAM_DEPTH:
        raise ValueError(f"scoring_cuda: the streaming kernel takes depth up to {_MAX_STREAM_DEPTH}, got {d}")
    if path == "tc" and (d % 4 != 0 or candidates.data_ptr() % 16 != 0):
        raise ValueError("scoring_cuda: the tensor-core kernel needs D % 4 == 0 and candidates "
                         "on a 16-byte boundary (TMA)")
    out = torch.empty(b, n, dtype=torch.float32, device=dev)
    if b == 0 or n == 0:
        return out
    # the tensor-core kernel's split queries, q_hi then q_lo
    scratch = torch.empty(2, b, d, dtype=torch.float32, device=dev) if path == "tc" else None
    args = (queries.data_ptr(), candidates.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(), b, n, d)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _lib()
    if width:
        status = lib.scoring_variant(*args, _PATHS[path], width, stream)
    else:
        status = lib.scoring(*args, stream)
    check(status, f"scoring ({path})")
    scoring_cuda.launches += 1
    scoring_cuda.launches_by_path[path] += 1
    return out


def scoring_cuda(queries: torch.Tensor, candidates: torch.Tensor) -> torch.Tensor:
    """Launch the kernel that :func:`_scoring_path` names on the current
    stream. ``N`` must be a multiple of ``CAND_TILE``, as the TPU kernel
    requires."""
    return _launch(queries, candidates)


def _scoring_variant(queries: torch.Tensor, candidates: torch.Tensor, path: str, width: int) -> torch.Tensor:
    """One kernel at a width of the caller's choosing (``"stream"``: 1, 2,
    4, 8 or 16 queries a chunk; ``"tc"``: 8, 16, ..., 128 queries a tile),
    for the tests and ``tools/scoring_ab.py``; the server calls
    :func:`scoring_cuda`."""
    if path not in _PATHS or width <= 0:
        raise ValueError(f"scoring variant: unknown path {path!r} or width {width}")
    return _launch(queries, candidates, path, width)


scoring_cuda.launches = 0
scoring_cuda.launches_by_path = {"stream": 0, "tc": 0}
