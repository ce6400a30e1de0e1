"""Embedding layers, including EmbeddingBag.

``mode="sum"`` (and the sum inside ``"mean"``) goes through
``kernels.embedding_bag``: the hand-written CUDA kernel on a CUDA table, its
plain version on a CPU one. ``"max"`` stays plain torch, as the reference
computes it with ``segment_max`` outside any kernel. In every mode an id
whose segment lies outside ``[0, num_bags)`` falls in no bag, as
``jax.ops.segment_sum`` and ``segment_max`` drop it.
"""
from __future__ import annotations

import torch

from ..kernels.embedding_bag import bag_index
from ..kernels.embedding_bag import embedding_bag as _bag_sum


def embed(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return table[ids.to(torch.int64)]


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
        rows = table[ids.reshape(-1).to(torch.int64)]
        if weights is not None:
            rows = rows * weights.reshape(-1)[:, None]
        # empty bags stay -inf, as the reference's segment_max leaves them
        out = torch.full((num_bags + 1, table.shape[1]), -torch.inf, dtype=rows.dtype, device=rows.device)
        idx = bag_index(segments.reshape(-1), num_bags)[:, None].expand_as(rows)
        return out.scatter_reduce_(0, idx, rows, "amax")[:num_bags]
    raise ValueError(mode)
