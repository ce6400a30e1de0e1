"""Embedding layers, including EmbeddingBag.

``mode="sum"`` (and the sum inside ``"mean"``) goes through
``kernels.embedding_bag``: the hand-written CUDA kernel on a CUDA table, its
plain version on a CPU one, and ``EmbeddingBagFunction`` where a gradient is
wanted. ``"max"`` stays plain torch under native autograd, as the reference
computes it with ``segment_max`` outside any kernel. In every mode an id
whose segment lies outside ``[0, num_bags)`` falls in no bag, as
``jax.ops.segment_sum`` and ``segment_max`` drop it, and ids follow
``jnp.take``'s rule, the reference's gather: an id in ``[-V, 0)`` reads row
``id + V``, any other id outside ``[0, V)`` a row of NaN (its bag comes out
NaN), and in the backward the wrapped ids get their gradient and the
NaN-filled ones none.
"""
from __future__ import annotations

import torch

from ..kernels.embedding_bag import bag_index, take_rows, wrap_ids
from ..kernels.embedding_bag import embedding_bag as _bag_sum


def embed(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return take_rows(table, ids)


def embedding_bag(
    table: torch.Tensor,     # [V, D]
    ids: torch.Tensor,       # [N] flat multi-hot indices
    segments: torch.Tensor,  # [N] bag id per index
    num_bags: int,
    *,
    mode: str = "sum",
    weights: torch.Tensor | None = None,
) -> torch.Tensor:
    """EmbeddingBag: gather rows then reduce per bag → [num_bags, D]."""
    if mode == "sum":
        return _bag_sum(table, ids, segments, num_bags, weights=weights)
    if mode == "mean":
        s = _bag_sum(table, ids, segments, num_bags, weights=weights)
        # the in-range id count per bag, weight-0 ids included, as the
        # reference counts
        bag = bag_index(segments.reshape(-1), num_bags)
        n = torch.zeros(num_bags + 1, dtype=s.dtype, device=s.device)
        n.index_add_(0, bag, torch.ones(bag.shape, dtype=s.dtype, device=s.device))
        return s / n[:num_bags].clamp_min(1)[:, None]
    if mode == "max":
        ids = ids.reshape(-1)
        rows = take_rows(table, ids)
        if weights is not None:
            rows = rows * weights.reshape(-1)[:, None]
        # the NaN rows of ids that read none go in as -inf, and their bags
        # are set to NaN after the max: in a NaN bag every row then gets a
        # zero gradient, as the reference's, where scatter_reduce's own
        # backward would give NaN
        _, inside = wrap_ids(ids, table.shape[0])
        bag = bag_index(segments.reshape(-1), num_bags)
        rows = torch.where(inside[:, None], rows, -torch.inf)
        # empty bags stay -inf, as the reference's segment_max leaves them
        out = torch.full((num_bags + 1, table.shape[1]), -torch.inf, dtype=rows.dtype, device=rows.device)
        out = out.scatter_reduce_(0, bag[:, None].expand_as(rows), rows, "amax")
        misses = torch.zeros(num_bags + 1, dtype=torch.int32, device=rows.device)
        misses.index_add_(0, bag, (~inside).to(torch.int32))
        return torch.where(misses[:, None] > 0, torch.nan, out)[:num_bags]
    raise ValueError(mode)
