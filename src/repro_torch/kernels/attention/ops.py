"""Device-dispatching attention entries: the CUDA kernel on CUDA tensors,
the plain blocked online softmax on CPU ones and on ``meta`` ones (the
dry-run's trace, where it computes nothing and its products are counted as
the backward's are). ``block_kv`` is the plain
version's KV block (and the backward's); the kernel tiles by its own
``BLOCK_K``.

Where a gradient is wanted (grad mode on and an input that requires it),
the call goes through :class:`FlashAttention`: the same forward, and the
gradient of the blocked online softmax in plain PyTorch
(``flash_attention_backward_plain``), the same on both devices."""
from __future__ import annotations

import torch

from .flash_attention import flash_attention_backward_plain, flash_attention_cuda, flash_attention_plain


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, block_kv: int) -> torch.Tensor:
    if q.device.type == "cuda":
        return flash_attention_cuda(q.contiguous(), k.contiguous(), v.contiguous())
    if q.device.type in ("cpu", "meta"):  # meta: the dry-run's trace, shapes and FLOPs, no work
        return flash_attention_plain(q, k, v, block_kv=block_kv)
    raise ValueError(f"flash_attention: unsupported device {q.device}")


class FlashAttention(torch.autograd.Function):
    """Causal attention with a gradient: ``apply(q, k, v, block_kv,
    forward=None)``. The forward is the kernel on CUDA and the plain version
    on the CPU, or ``forward(q, k, v) -> out`` where the caller gives one
    (``chip_smoke.py`` passes the plain version on the card); it saves
    q, k, v and the output, and the backward recomputes the rest."""

    @staticmethod
    def forward(ctx, q, k, v, block_kv: int, forward=None):
        out = _forward(q, k, v, block_kv) if forward is None else forward(q, k, v)
        ctx.save_for_backward(q, k, v, out)
        ctx.block_kv = block_kv
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward_plain(q, k, v, out, dout, block_kv=ctx.block_kv)
        return dq, dk, dv, None, None


def flash_attention_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, block_kv: int = 512):
    """q: [B, S, H, Dh], k/v: [B, S, K, Dh] (not expanded) -> [B, S, H, Dh]."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttention.apply(q, k, v, block_kv)
    return _forward(q, k, v, block_kv)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, block_kv: int = 512):
    """q/k/v: [B, S, H, D] (same H — expand GQA beforehand) -> [B, S, H, D],
    the reference's signature; :func:`flash_attention_gqa` takes K < H."""
    if not (q.shape == k.shape == v.shape):
        raise ValueError(f"flash_attention: q/k/v shapes differ: {q.shape}, {k.shape}, {v.shape}")
    return flash_attention_gqa(q, k, v, block_kv=block_kv)
