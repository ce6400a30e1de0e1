"""EmbeddingBag: the CUDA kernel's wrapper and its plain version.

Replaces ``repro/kernels/embedding_bag/embedding_bag.py::embedding_bag_pallas``.
Both functions return the float32 ``[num_bags, D]`` per-bag sums
``out[b] = Σ weights[i] * table[ids[i]]`` over the ``i`` with
``segments[i] == b``; a bag with no ids comes out as zeros. ``ids`` and
``segments`` are int32, ``segments`` sorted non-decreasing (the kernel
finds each bag's ids from it), ``weights`` float32 or ``None`` for all
ones. An id whose segment lies outside ``[0, num_bags)`` falls in no bag,
as ``jax.ops.segment_sum`` drops it. Ids follow ``jnp.take``'s rule, the
reference's gather (:func:`take_rows`): an id in ``[-V, 0)`` reads row
``id + V``, and any other id outside ``[0, V)`` reads a row of NaN, so its
bag comes out NaN whatever its weight. The source and its design note are
``csrc/embedding_bag.cu``.
"""
from __future__ import annotations

import ctypes

import torch

from .._build import check, load


def bag_index(segments: torch.Tensor, num_bags: int) -> torch.Tensor:
    """int64 bag of each id, with ids outside ``[0, num_bags)`` sent to one
    extra row ``num_bags`` that the caller cuts off: tensor ops only, so a
    CUDA caller never waits on the host."""
    seg = segments.to(torch.int64)
    return torch.where((seg >= 0) & (seg < num_bags), seg, num_bags)


def wrap_ids(ids: torch.Tensor, rows: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``jnp.take``'s index rule on ``rows`` rows: the int64 row each id
    reads (``id + rows`` for an id in ``[-rows, 0)``; 0 for an id outside
    ``[-rows, rows)``) and whether it reads one (False where the reference
    fills NaN and drops the gradient). Tensor ops only: no host sync."""
    ids = ids.to(torch.int64)
    wrapped = torch.where(ids < 0, ids + rows, ids)
    inside = (wrapped >= 0) & (wrapped < rows)
    return torch.where(inside, wrapped, 0), inside


def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, ids, axis=0)``: ``table[ids]`` with negative ids
    wrapped and rows of NaN for ids past either end. Differentiable in
    ``table``: the NaN-filled rows send it no gradient."""
    row, inside = wrap_ids(ids, table.shape[0])
    return table[row].masked_fill_(~inside.reshape(*inside.shape, 1), torch.nan)


def embedding_bag_plain(
    table: torch.Tensor,
    ids: torch.Tensor,
    segments: torch.Tensor,
    weights: torch.Tensor | None,
    num_bags: int,
) -> torch.Tensor:
    """Plain PyTorch version: gather (:func:`take_rows`), scale,
    ``index_add_`` per bag. Differentiable by autograd."""
    rows = take_rows(table, ids)
    if weights is not None:
        rows = rows * weights[:, None]
    out = torch.zeros(num_bags + 1, table.shape[1], dtype=table.dtype, device=table.device)
    return out.index_add_(0, bag_index(segments, num_bags), rows)[:num_bags]


def _lib() -> ctypes.CDLL:
    lib = load("embedding_bag")
    fn = lib.embedding_bag
    if fn.argtypes is None:  # first load: declare the C signature
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        fn.argtypes = [p, i64, i64, p, p, p, i64, p, i64, p]
        fn.restype = ctypes.c_int
    return lib


def embedding_bag_cuda(
    table: torch.Tensor,
    ids: torch.Tensor,
    segments: torch.Tensor,
    weights: torch.Tensor | None,
    num_bags: int,
) -> torch.Tensor:
    """Launch the CUDA kernel (one launch, no scratch) on the current
    stream. ``segments`` must be sorted: the caller's to ensure (checking
    would cost a sync with the host). Ids outside ``[0, V)`` take
    ``jnp.take``'s rule, checked by the kernel as it loads each id."""
    dev = table.device
    named = [("table", table, torch.float32, 2), ("ids", ids, torch.int32, 1),
             ("segments", segments, torch.int32, 1)]
    if weights is not None:
        named.append(("weights", weights, torch.float32, 1))
    for name, t, dtype, dim in named:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"embedding_bag_cuda: {name} must be on {dev}, got {t.device}")
        if t.dtype != dtype or t.dim() != dim or not t.is_contiguous():
            raise ValueError(
                f"embedding_bag_cuda: {name} must be a contiguous {dim}-D {dtype} tensor"
            )
    n = ids.shape[0]
    if segments.shape[0] != n or (weights is not None and weights.shape[0] != n):
        raise ValueError("embedding_bag_cuda: ids, segments and weights differ in length")
    if n > 2**31 - 1 or num_bags >= 2**31 - 1 or table.shape[0] >= 2**31 - 1:
        raise ValueError("embedding_bag_cuda: the kernel indexes rows, ids and bags in 32 bits")
    if table.shape[0] == 0 and n > 0:
        raise ValueError("embedding_bag_cuda: the table has no rows for the ids to read")
    out = torch.empty(num_bags, table.shape[1], dtype=torch.float32, device=dev)
    if num_bags <= 0:
        return out
    status = _lib().embedding_bag(
        table.data_ptr(), table.shape[0], table.shape[1], ids.data_ptr(), segments.data_ptr(),
        None if weights is None else weights.data_ptr(), n, out.data_ptr(), num_bags,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    check(status, "embedding_bag")
    embedding_bag_cuda.launches += 1
    return out


embedding_bag_cuda.launches = 0
