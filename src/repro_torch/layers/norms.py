"""Normalization layers (pure functions over parameter dicts): float32 math,
the result cast back to the input's type."""
from __future__ import annotations

import torch


def rmsnorm_init(dim: int, dtype=torch.float32):
    return {"scale": torch.ones(dim, dtype=dtype)}


def rmsnorm(params, x: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(x.dtype)


def layernorm_init(dim: int, dtype=torch.float32):
    return {"scale": torch.ones(dim, dtype=dtype), "bias": torch.zeros(dim, dtype=dtype)}


def layernorm(params, x: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, unbiased=False)
    y = (x32 - mu) * (var + eps) ** -0.5
    y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)
