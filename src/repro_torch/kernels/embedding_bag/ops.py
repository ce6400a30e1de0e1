"""Device-dispatching EmbeddingBag entry: stably sort the (id, segment)
pairs by segment, as the reference's ``ops.embedding_bag`` does, then run
the CUDA kernel on a CUDA table and the plain version on a CPU one.

The reference also appends one weight-0 sentinel per bag so that the TPU's
revisit pattern initialises every output row; the kernel writes every bag
itself (empty bags as zeros), so the port needs no sentinels."""
from __future__ import annotations

import torch

from .embedding_bag import embedding_bag_cuda, embedding_bag_plain


def embedding_bag(table, ids, segments, num_bags: int, *, weights=None) -> torch.Tensor:
    """``[num_bags, D]`` per-bag weighted sums of ``table`` rows (see
    ``embedding_bag.py``); ``segments`` may come in any order."""
    segments, order = torch.sort(segments.to(torch.int32).reshape(-1), stable=True)
    ids = ids.to(torch.int32).reshape(-1)[order]
    if weights is not None:
        weights = weights.to(table.dtype).reshape(-1)[order]
    if table.device.type == "cuda":
        return embedding_bag_cuda(table, ids, segments, weights, num_bags)
    if table.device.type == "cpu":
        return embedding_bag_plain(table, ids, segments, weights, num_bags)
    raise ValueError(f"embedding_bag: unsupported device {table.device}")
