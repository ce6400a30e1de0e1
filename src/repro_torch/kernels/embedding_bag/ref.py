"""Plain-torch oracle: gather, scale, segment sum (the reference's
``take`` + ``segment_sum``: ids outside ``[0, V)`` take ``jnp.take``'s rule,
and ids whose segment lies outside ``[0, num_bags)`` are dropped)."""
import torch

from .embedding_bag import take_rows


def embedding_bag_ref(table, ids, segments, weights, num_bags: int) -> torch.Tensor:
    rows = take_rows(table, ids) * weights[:, None]
    seg = segments.to(torch.int64)
    keep = (seg >= 0) & (seg < num_bags)
    out = torch.zeros(num_bags, table.shape[1], dtype=table.dtype, device=table.device)
    return out.index_add_(0, seg[keep], rows[keep])
