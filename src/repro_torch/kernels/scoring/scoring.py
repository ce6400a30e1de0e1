"""Candidate scoring: the CUDA kernel's wrapper and its plain version.

Replaces ``repro/kernels/scoring/scoring.py::scoring_pallas``. Both
functions take float32 ``queries [B, D]`` and ``candidates [N, D]`` and
return the float32 scores ``[B, N] = queries @ candidates.T``, in full
float32 (no TF32). The source and its design note are ``csrc/scoring.cu``.
"""
from __future__ import annotations

import ctypes

import torch

from .._build import check, load

CAND_TILE = 2048     # candidates per tile, as in the TPU kernel; N is padded to it
_MAX_BATCH = 65535 * 64  # the kernel's grid holds 65,535 tiles of 64 queries


def scoring_plain(queries: torch.Tensor, candidates: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: one float32 matrix product."""
    return queries @ candidates.T


def _lib() -> ctypes.CDLL:
    lib = load("scoring")
    fn = lib.scoring
    if fn.argtypes is None:  # first load: declare the C signature
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        fn.argtypes = [p, p, p, i64, i64, i64, p]
        fn.restype = ctypes.c_int
    return lib


def scoring_cuda(queries: torch.Tensor, candidates: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream. ``N`` must be a
    multiple of ``CAND_TILE``, as the TPU kernel requires."""
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
    out = torch.empty(b, n, dtype=torch.float32, device=dev)
    if b == 0 or n == 0:
        return out
    status = _lib().scoring(
        queries.data_ptr(), candidates.data_ptr(), out.data_ptr(), b, n, d,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check(status, "scoring")
    scoring_cuda.launches += 1
    return out


scoring_cuda.launches = 0
