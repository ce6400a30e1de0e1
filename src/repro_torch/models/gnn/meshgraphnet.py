"""MeshGraphNet [arXiv:2010.03409]: encode-process-decode interaction network.

Config: n_layers=15 processor blocks, d_hidden=128, sum aggregation,
2-layer MLPs with LayerNorm (the paper's defaults).

The reference scans its stacked ``blocks`` with ``lax.scan``; here they
are an ``nn.ModuleList`` run in a Python loop. Its ``constrain``
(activation sharding) and ``scan_unroll`` have no counterpart on one
device.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from ...graph.structure import resolve_device, seeded_generator
from .common import MLP, aggregate, masked_mse, state_from_tree


@dataclasses.dataclass(frozen=True)
class MGNConfig:
    name: str = "meshgraphnet"
    n_layers: int = 15
    d_hidden: int = 128
    mlp_layers: int = 2
    aggregator: str = "sum"
    d_node_in: int = 16
    d_edge_in: int = 8
    d_out: int = 3
    dtype: Any = torch.float32


def _mlp_sizes(cfg: MGNConfig, d_in: int, d_out: int | None = None) -> list[int]:
    return [d_in] + [cfg.d_hidden] * cfg.mlp_layers + [d_out or cfg.d_hidden]


class MeshGraphNet(nn.Module):
    """The reference's ``init_params`` tree as modules (MLP weights normal *
    fan_in**-0.5, biases zero, layernorms 1 and 0), drawn from a
    ``torch.Generator`` seeded with ``seed`` on the model's device, the card
    unless the caller names another. The numbers differ from the
    reference's (another generator); :func:`params_from_jax` carries those
    across."""

    def __init__(self, cfg: MGNConfig, *, seed: int = 0, device=None):
        super().__init__()
        dev = resolve_device(device)
        gen = seeded_generator(dev, seed)
        d = cfg.d_hidden

        def mlp(sizes, **kw) -> MLP:
            return MLP(sizes, dtype=cfg.dtype, device=dev, generator=gen, **kw)

        self.cfg = cfg
        self.node_encoder = mlp(_mlp_sizes(cfg, cfg.d_node_in))
        self.edge_encoder = mlp(_mlp_sizes(cfg, cfg.d_edge_in))
        self.decoder = mlp(_mlp_sizes(cfg, d, cfg.d_out), layernorm=False)
        self.blocks = nn.ModuleList(
            nn.ModuleDict({"edge_mlp": mlp(_mlp_sizes(cfg, 3 * d)), "node_mlp": mlp(_mlp_sizes(cfg, 2 * d))})
            for _ in range(cfg.n_layers)
        )


MODEL = MeshGraphNet  # the model class of this module (``launch.steps.make_gnn_cell`` builds it)


def params_from_jax(cfg: MGNConfig, tree: dict) -> dict[str, torch.Tensor]:
    """The state dict of :class:`MeshGraphNet` from the reference's tree
    (its ``blocks`` stacked on axis 0; numpy arrays or tensors)."""
    return state_from_tree(tree, "blocks", cfg.n_layers)


def forward(cfg: MGNConfig, model: MeshGraphNet, batch: dict) -> torch.Tensor:
    """→ per-node outputs [N, d_out]."""
    n = batch["nodes"].shape[0]
    src, dst = batch["src"].long(), batch["dst"].long()
    emask = batch["edge_mask"][:, None].to(cfg.dtype)

    h = model.node_encoder(batch["nodes"].to(cfg.dtype))
    e = model.edge_encoder(batch["edge_feat"].to(cfg.dtype)) * emask
    for block in model.blocks:
        msg_in = torch.cat([e, h.index_select(0, src), h.index_select(0, dst)], dim=-1)
        e = e + block["edge_mlp"](msg_in) * emask
        agg = aggregate(e * emask, dst, n, cfg.aggregator)
        h = h + block["node_mlp"](torch.cat([h, agg], dim=-1))
    return model.decoder(h)


def loss_fn(cfg: MGNConfig, model: MeshGraphNet, batch: dict) -> torch.Tensor:
    pred = forward(cfg, model, batch)
    return masked_mse(pred, batch["targets"], batch["node_mask"].float())

