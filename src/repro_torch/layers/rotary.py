"""Rotary position embeddings (RoPE), in the half-split form: the head dim
is split into two halves ``x1, x2`` and rotated as
``[x1 cos - x2 sin, x1 sin + x2 cos]`` (not the interleaved pairs)."""
from __future__ import annotations

import torch


def rope_frequencies(head_dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: broadcastable to [..., seq]."""
    freqs = rope_frequencies(x.shape[-1], theta, device=x.device)         # [half]
    angles = positions[..., :, None, None].float() * freqs                # [..., seq, 1, half]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
