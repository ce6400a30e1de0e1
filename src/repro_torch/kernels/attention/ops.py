"""Device-dispatching attention entries: the CUDA kernel on CUDA tensors,
the plain blocked online softmax on CPU ones. ``block_kv`` is the plain
version's KV block; the kernel tiles by its own ``BLOCK_K``."""
from __future__ import annotations

import torch

from .flash_attention import flash_attention_cuda, flash_attention_plain


def flash_attention_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, block_kv: int = 512):
    """q: [B, S, H, Dh], k/v: [B, S, K, Dh] (not expanded) -> [B, S, H, Dh]."""
    if q.device.type == "cuda":
        return flash_attention_cuda(q.contiguous(), k.contiguous(), v.contiguous())
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, block_kv=block_kv)
    raise ValueError(f"flash_attention: unsupported device {q.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, block_kv: int = 512):
    """q/k/v: [B, S, H, D] (same H — expand GQA beforehand) -> [B, S, H, D],
    the reference's signature; :func:`flash_attention_gqa` takes K < H."""
    if not (q.shape == k.shape == v.shape):
        raise ValueError(f"flash_attention: q/k/v shapes differ: {q.shape}, {k.shape}, {v.shape}")
    return flash_attention_gqa(q, k, v, block_kv=block_kv)
