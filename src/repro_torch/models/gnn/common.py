"""The MLP shared by the GNNs and the two-tower towers: linear layers with
ReLU between them and an optional layernorm (eps 1e-5) after the last.

:class:`MLP` is the reference's ``mlp_init`` (its constructor) and
``mlp_apply`` (its forward) as one ``nn.Module``. The reference stores each
weight ``[in, out]`` and applies it with an einsum; here it is an
``nn.Linear`` (``[out, in]``), and :func:`mlp_state_from_jax` transposes
the reference's weights into it. The GNN parts of the reference's module
wait for the GNN slice.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F


class MLP(nn.Module):
    def __init__(self, sizes: list[int], *, layernorm: bool = True, dtype=torch.float32,
                 device=None, generator: torch.Generator | None = None):
        super().__init__()
        self.layers = nn.ModuleList(
            nn.Linear(a, b, device=device, dtype=dtype) for a, b in zip(sizes[:-1], sizes[1:])
        )
        # the reference's init: weights normal * fan_in**-0.5, biases zero
        with torch.no_grad():
            for layer in self.layers:
                layer.weight.normal_(generator=generator).mul_(layer.in_features ** -0.5)
                layer.bias.zero_()
        self.norm = (nn.LayerNorm(sizes[-1], eps=1e-5, device=device, dtype=dtype)
                     if layernorm else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n = len(self.layers)
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < n - 1:
                x = F.relu(x)
        return x if self.norm is None else self.norm(x)


def mlp_state_from_jax(tree: dict) -> dict[str, torch.Tensor]:
    """State-dict entries of :class:`MLP` from the reference's ``mlp_init``
    tree (nested dicts of numpy arrays): each ``[in, out]`` weight becomes
    ``layers.<i>.weight`` as ``[out, in]``."""
    out: dict[str, torch.Tensor] = {}
    for i, layer in enumerate(tree["layers"]):
        out[f"layers.{i}.weight"] = torch.from_numpy(np.ascontiguousarray(np.asarray(layer["w"]).T))
        out[f"layers.{i}.bias"] = torch.from_numpy(np.array(layer["b"]))
    if "ln_scale" in tree:
        out["norm.weight"] = torch.from_numpy(np.array(tree["ln_scale"]))
        out["norm.bias"] = torch.from_numpy(np.array(tree["ln_bias"]))
    return out
