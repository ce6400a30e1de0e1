"""Attention layers: GQA with RoPE, blocked-causal attention (online softmax
over KV blocks: memory O(seq·block) instead of O(seq²)), and decode
attention against a KV cache.

The blocked functions are the reference's pure-JAX twin of its Pallas flash
kernel. Here they dispatch on the tensors' device: on CUDA they launch the
hand-written kernel (``kernels.attention``), which takes grouped KV heads
and any sequence length itself; on the CPU they run its plain version, the
blocked online softmax. ``decode_attention`` and ``full_causal_attention``
are plain torch, as the reference's are plain JAX.
"""
from __future__ import annotations

import torch

from ..kernels.attention import flash_attention_gqa
from .rotary import apply_rope

NEG_INF = -1e30


def gqa_project(params, x: torch.Tensor):
    """x: [B, S, D] → q: [B, S, H, Dh], k/v: [B, S, K, Dh] (contiguous)."""
    b, s, d = x.shape

    def proj(w):  # [D, heads, Dh]: one product over the flattened heads
        return (x @ w.reshape(d, -1)).view(b, s, w.shape[1], w.shape[2])

    return proj(params["wq"]), proj(params["wk"]), proj(params["wv"])


def repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """[B, S, K, Dh] → [B, S, K·groups, Dh] by repeating each KV head."""
    if groups == 1:
        return k
    b, s, kh, d = k.shape
    return k[:, :, :, None, :].expand(b, s, kh, groups, d).reshape(b, s, kh * groups, d)


def blocked_causal_attention(
    q: torch.Tensor,  # [B, S, H, Dh]
    k: torch.Tensor,  # [B, S, H, Dh] (already GQA-expanded)
    v: torch.Tensor,
    *,
    block_kv: int = 512,
) -> torch.Tensor:
    """Causal attention with online softmax over KV blocks (flash-style)."""
    return flash_attention_gqa(q, k, v, block_kv=block_kv)


def blocked_causal_attention_gqa(
    q: torch.Tensor,  # [B, S, K, G, Dh]: query heads grouped per KV head
    k: torch.Tensor,  # [B, S, K, Dh]: NOT expanded
    v: torch.Tensor,
    *,
    block_kv: int = 512,
) -> torch.Tensor:
    """GQA flash attention without KV expansion: each KV head is read once
    for its G query heads. Returns [B, S, K·G, Dh]."""
    b, s, kh, g, dh = q.shape
    return flash_attention_gqa(q.reshape(b, s, kh * g, dh), k, v, block_kv=block_kv)


def full_causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Unblocked reference (small seqs / tests)."""
    b, s, h, dh = q.shape
    scale = dh**-0.5
    scores = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) * scale
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~mask, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhst,bthd->bshd", p, v.float()).to(q.dtype)


def decode_attention(
    q: torch.Tensor,          # [B, 1, H, Dh]: one new token
    k_cache: torch.Tensor,    # [B, S, K, Dh]
    v_cache: torch.Tensor,    # [B, S, K, Dh]
    cache_len: torch.Tensor,  # [B] int valid lengths
    *,
    q_per_kv: int,
) -> torch.Tensor:
    """Single-token attention over the KV cache, the query heads grouped
    onto their KV head (the cache is read once, not expanded).

    Output: [B, 1, H, Dh]."""
    b, s, kh, dh = k_cache.shape
    scale = dh**-0.5
    qg = q.reshape(b, kh, q_per_kv, dh).float() * scale                  # [B,K,G,Dh]
    scores = torch.einsum("bkgd,bskd->bkgs", qg, k_cache.float())
    mask = torch.arange(s, device=q.device)[None, :] < cache_len[:, None]  # [B,S]
    scores = scores.masked_fill(~mask[:, None, None, :], NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return out.reshape(b, 1, kh * q_per_kv, dh).to(q.dtype)


def attention_layer(
    params,
    x: torch.Tensor,           # [B, S, D]
    positions: torch.Tensor,   # [B, S]
    *,
    n_kv_heads: int,
    rope_theta: float = 10000.0,
    block_kv: int = 512,
    use_blocked: bool = True,
    grouped_gqa: bool = True,
) -> torch.Tensor:
    q, k, v = gqa_project(params, x)
    q = apply_rope(q, positions, rope_theta)
    k = apply_rope(k, positions, rope_theta)
    groups = q.shape[2] // n_kv_heads
    if use_blocked and grouped_gqa and groups >= 1:
        b, s, h, dh = q.shape
        qg = q.reshape(b, s, n_kv_heads, groups, dh)
        attn = blocked_causal_attention_gqa(qg, k, v, block_kv=block_kv)
    else:
        k = repeat_kv(k, groups)
        v = repeat_kv(v, groups)
        attn = (
            blocked_causal_attention(q, k, v, block_kv=block_kv)
            if use_blocked
            else full_causal_attention(q, k, v)
        )
    b, s, h, dh = attn.shape
    return attn.reshape(b, s, h * dh) @ params["wo"].reshape(h * dh, -1)
