"""Device-dispatching EmbeddingBag entry: stably sort the (id, segment)
pairs by segment, as the reference's ``ops.embedding_bag`` does, then run
the CUDA kernel on a CUDA table and the plain version on a CPU one (on a
``meta`` one, the dry-run's, give the output's shape alone).

The reference also appends one weight-0 sentinel per bag so that the TPU's
revisit pattern initialises every output row; the kernel writes every bag
itself (empty bags as zeros), so the port needs no sentinels.

Where a gradient is wanted (grad mode on and a table or weights that
require it), the call goes through :class:`EmbeddingBagFunction`: the same
forward, and the gradient of the reference's ``take`` + ``segment_sum`` in
plain PyTorch, the same on both devices. The JAX package has no backward
kernel (XLA differentiates its gather and segment sum), so neither has the
port."""
from __future__ import annotations

import torch

from .embedding_bag import bag_index, embedding_bag_cuda, embedding_bag_plain, take_rows, wrap_ids


def _forward(table, ids, segments, weights, num_bags: int) -> torch.Tensor:
    if table.device.type == "cuda":
        return embedding_bag_cuda(table, ids, segments, weights, num_bags)
    if table.device.type == "cpu":
        return embedding_bag_plain(table, ids, segments, weights, num_bags)
    if table.device.type == "meta":  # the dry-run's trace: the plain version's shape and type, no work
        return table.new_empty((num_bags, table.shape[1]))
    raise ValueError(f"embedding_bag: unsupported device {table.device}")


class EmbeddingBagFunction(torch.autograd.Function):
    """Per-bag weighted sums with a gradient: ``apply(table, ids, segments,
    weights, num_bags)`` on ids and weights sorted by segment (int32
    ``ids``/``segments``, ``weights`` float32 or None). The forward is the
    kernel on CUDA and the plain version on the CPU; it saves its inputs.

    The backward is the reference's gradient, dense as XLA's: the table's is
    ``zeros(V, D).index_add_(0, row, w * grad_out[seg])`` over the ids that
    read a row (``jnp.take``'s rule: wrapped ids get theirs, NaN-filled ids
    none) in a segment inside ``[0, num_bags)``; the weights' is
    ``(grad_out[seg] * take(table, ids)).sum(-1)``, 0 outside the bags and
    NaN at a NaN-filled id, as the reference's product rule gives."""

    @staticmethod
    def forward(ctx, table, ids, segments, weights, num_bags: int):
        ctx.save_for_backward(table, ids, segments, weights)
        ctx.num_bags = num_bags
        return _forward(table, ids, segments, weights, num_bags)

    @staticmethod
    def backward(ctx, grad_out):
        table, ids, segments, weights = ctx.saved_tensors
        num_bags = ctx.num_bags
        bag = bag_index(segments, num_bags)
        # each id's bag gradient; an id outside the bags reads the zero row
        g = torch.cat([grad_out, grad_out.new_zeros(1, grad_out.shape[1])])[bag]
        grad_table = grad_weights = None
        if ctx.needs_input_grad[0]:
            row, inside = wrap_ids(ids, table.shape[0])
            keep = inside & (bag < num_bags)
            contrib = g if weights is None else weights[:, None] * g
            # dropped ids add an exact zero to row 0: no host sync to cut them out
            contrib = torch.where(keep[:, None], contrib, 0.0)
            grad_table = torch.zeros_like(table).index_add_(0, torch.where(keep, row, 0), contrib)
        if weights is not None and ctx.needs_input_grad[3]:
            grad_weights = (g * take_rows(table, ids)).sum(-1)
        return grad_table, None, None, grad_weights, None


def embedding_bag(table, ids, segments, num_bags: int, *, weights=None) -> torch.Tensor:
    """``[num_bags, D]`` per-bag weighted sums of ``table`` rows (see
    ``embedding_bag.py``); ``segments`` may come in any order."""
    segments, order = torch.sort(segments.to(torch.int32).reshape(-1), stable=True)
    ids = ids.to(torch.int32).reshape(-1)[order]
    if weights is not None:
        weights = weights.to(table.dtype).reshape(-1)[order]
    if torch.is_grad_enabled() and (table.requires_grad or (weights is not None and weights.requires_grad)):
        return EmbeddingBagFunction.apply(table, ids, segments, weights, num_bags)
    return _forward(table, ids, segments, weights, num_bags)
