"""Error-feedback int8 gradient compression for a cross-pod all-reduce
[Seide et al. 2014; Karimireddy et al. 2019]: each leaf is quantized to
int8 with one per-tensor scale, and the quantization error is carried in
the residuals and added to the next step's gradients.

    state = ef_init(grads_like)
    msg, state = ef_compress(grads, state)   # int8 payload + scales
    grads = ef_decompress(msg)

Plain elementwise ops over nested dicts of tensors, as the reference's
``repro.optim.compression``.
"""
from __future__ import annotations

import torch

from .._tree import tree_map, tree_unzip


def ef_init(grads_template):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device), grads_template)


def _quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = x.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def ef_compress(grads, residuals):
    """-> (payload {q, scale} tree, new residuals)."""

    def one(g, r):
        x = g.float() + r
        q, scale = _quantize(x)
        return {"q": q, "scale": scale}, x - q.float() * scale

    return tree_unzip(tree_map(one, grads, residuals), 2)


def ef_decompress(payload):
    """payload {q, scale} tree -> fp32 grads tree."""
    if "q" in payload:
        return payload["q"].float() * payload["scale"]
    return {k: ef_decompress(v) for k, v in payload.items()}


def compressed_bytes(payload) -> int:
    if "q" in payload:
        return payload["q"].numel() + 4
    return sum(compressed_bytes(v) for v in payload.values())
