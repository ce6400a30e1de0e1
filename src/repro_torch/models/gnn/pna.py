"""Principal Neighbourhood Aggregation [arXiv:2004.05718].

Config: 4 layers, d_hidden=75, aggregators {mean, max, min, std},
scalers {identity, amplification, attenuation} — 12 combined channels per
message round, mixed by a linear tower.

The reference's stacked ``towers`` are an ``nn.ModuleList`` run in a
Python loop; ``constrain`` and ``scan_unroll`` are dropped (one device).
Reproduced as the reference has them: the in-degree sums the masked edge
weights, so ``s_att`` is ``delta / EPS`` (250,000 at delta 2.5) at a node
with no valid in-edge; masked edges still bring zero messages to their
padded endpoints (node 0 of a sampled block) in max and min.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch import nn

from ...graph.structure import resolve_device, seeded_generator
from .common import MLP, aggregate, masked_ce, state_from_tree

EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class PNAConfig:
    name: str = "pna"
    n_layers: int = 4
    d_hidden: int = 75
    aggregators: tuple = ("mean", "max", "min", "std")
    scalers: tuple = ("identity", "amplification", "attenuation")
    d_node_in: int = 16
    n_classes: int = 10
    mlp_layers: int = 2
    # mean log-degree of the training graphs (delta in the paper)
    delta: float = 2.5
    dtype: Any = torch.float32


class PNA(nn.Module):
    """The reference's ``init_params`` tree as modules, drawn from a
    ``torch.Generator`` seeded with ``seed`` on the model's device (the card
    unless the caller names another); :func:`params_from_jax` carries the
    reference's numbers across."""

    def __init__(self, cfg: PNAConfig, *, seed: int = 0, device=None):
        super().__init__()
        dev = resolve_device(device)
        gen = seeded_generator(dev, seed)
        d = cfg.d_hidden
        n_ch = len(cfg.aggregators) * len(cfg.scalers)

        def mlp(sizes, **kw) -> MLP:
            return MLP(sizes, dtype=cfg.dtype, device=dev, generator=gen, **kw)

        self.cfg = cfg
        self.encoder = mlp([cfg.d_node_in, d], layernorm=False)
        self.head = mlp([d, d, cfg.n_classes], layernorm=False)
        self.towers = nn.ModuleList(
            nn.ModuleDict({"pre": mlp([2 * d] + [d] * cfg.mlp_layers), "post": mlp([n_ch * d, d])})
            for _ in range(cfg.n_layers)
        )


MODEL = PNA  # the model class of this module (``launch.steps.make_gnn_cell`` builds it)


def params_from_jax(cfg: PNAConfig, tree: dict) -> dict[str, torch.Tensor]:
    """The state dict of :class:`PNA` from the reference's tree (its
    ``towers`` stacked on axis 0)."""
    return state_from_tree(tree, "towers", cfg.n_layers)


def _std_from_moments(mean: torch.Tensor, mean_sq: torch.Tensor) -> torch.Tensor:
    # the variance is exactly 0 at every node with 0 or 1 in-edges; there
    # jnp.maximum and torch.maximum pass half the gradient to each side,
    # where clamp_min would pass all of it
    return torch.sqrt(torch.maximum(mean_sq - mean**2, torch.zeros_like(mean)) + EPS)


def _std_aggregate(msg: torch.Tensor, dst: torch.Tensor, n: int) -> torch.Tensor:
    return _std_from_moments(aggregate(msg, dst, n, "mean"), aggregate(msg * msg, dst, n, "mean"))


def forward(cfg: PNAConfig, model: PNA, batch: dict) -> torch.Tensor:
    n = batch["nodes"].shape[0]
    src, dst = batch["src"].long(), batch["dst"].long()
    emask = batch["edge_mask"].to(cfg.dtype)

    # in-degree for scalers (no gradient flows through them)
    deg = aggregate(emask, dst, n, "sum")
    log_deg = torch.log(deg + 1.0)
    s_amp = (log_deg / cfg.delta)[:, None]
    s_att = (cfg.delta / torch.clamp_min(log_deg, EPS))[:, None]

    h = model.encoder(batch["nodes"].to(cfg.dtype))
    for tower in model.towers:
        msg = tower["pre"](torch.cat([h.index_select(0, src), h.index_select(0, dst)], dim=-1)) * emask[:, None]
        outs = []
        for agg_name in cfg.aggregators:
            a = _std_aggregate(msg, dst, n) if agg_name == "std" else aggregate(msg, dst, n, agg_name)
            for scaler in cfg.scalers:
                if scaler == "identity":
                    outs.append(a)
                elif scaler == "amplification":
                    outs.append(a * s_amp)
                else:
                    outs.append(a * s_att)
        h = h + tower["post"](torch.cat(outs, dim=-1))
    return model.head(h)


def loss_fn(cfg: PNAConfig, model: PNA, batch: dict) -> torch.Tensor:
    logits = forward(cfg, model, batch)
    return masked_ce(logits, batch["targets"], batch["node_mask"].float())
