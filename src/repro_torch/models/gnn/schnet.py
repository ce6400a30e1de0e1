"""SchNet [arXiv:1706.08566]: continuous-filter convolutions for molecules.

Config: 3 interaction blocks, d_hidden=64, 300 radial basis functions,
cutoff 10 Å. Per-molecule energy = sum-pooled atom-wise readout.

The reference's stacked ``interactions`` are an ``nn.ModuleList`` run in
a Python loop; ``constrain`` and ``scan_unroll`` are dropped (one device).
An atom type outside ``[0, n_atom_types)`` raises (the reference's
``jnp.take`` wraps -1 and fills NaN past the end): invalid input, not a
result.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch import nn

from ...graph.structure import resolve_device, seeded_generator
from .common import MLP, aggregate, state_from_tree


@dataclasses.dataclass(frozen=True)
class SchNetConfig:
    name: str = "schnet"
    n_interactions: int = 3
    d_hidden: int = 64
    n_rbf: int = 300
    cutoff: float = 10.0
    n_atom_types: int = 100
    dtype: Any = torch.float32


def shifted_softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus(x) - log 2``; JAX's softplus is ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x)) - math.log(2.0)


def rbf_expand(dist: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    """Gaussian radial basis: centers on [0, cutoff], gamma from spacing.
    The centers are ``jnp.linspace(0, cutoff, n_rbf)`` in float32 as XLA
    computes it (``stop * (iota / (n - 1))`` folded to ``(stop * (1 / (n -
    1))) * iota``, then ``stop``), bit for bit: with 300 centers gamma is
    ~900, and a center one float32 step off moves a basis value by up to
    1e-4 of itself."""
    f32 = dict(dtype=torch.float32, device=dist.device)
    stop = torch.full((1,), cutoff, **f32)
    spacing = stop * (torch.ones(1, **f32) / (n_rbf - 1))
    centers = torch.cat([spacing * torch.arange(n_rbf - 1, **f32), stop])
    gamma = 1.0 / (centers[1] - centers[0]) ** 2
    return torch.exp(-gamma * (dist[:, None] - centers[None, :]) ** 2)


class SchNet(nn.Module):
    """The reference's ``init_params`` tree as modules (the embedding
    normal * 0.1), drawn from a ``torch.Generator`` seeded with ``seed`` on
    the model's device (the card unless the caller names another);
    :func:`params_from_jax` carries the reference's numbers across."""

    def __init__(self, cfg: SchNetConfig, *, seed: int = 0, device=None):
        super().__init__()
        dev = resolve_device(device)
        gen = seeded_generator(dev, seed)
        d = cfg.d_hidden

        def mlp(sizes, **kw) -> MLP:
            return MLP(sizes, layernorm=False, dtype=cfg.dtype, device=dev, generator=gen, **kw)

        self.cfg = cfg
        self.embedding = nn.Parameter(
            torch.empty(cfg.n_atom_types, d, dtype=cfg.dtype, device=dev).normal_(generator=gen).mul_(0.1))
        self.readout = mlp([d, d // 2, 1], activation=shifted_softplus)
        self.interactions = nn.ModuleList(
            nn.ModuleDict({
                "filter": mlp([cfg.n_rbf, d, d], activation=shifted_softplus),
                "in_proj": mlp([d, d]),
                "out_mlp": mlp([d, d, d], activation=shifted_softplus),
            })
            for _ in range(cfg.n_interactions)
        )


MODEL = SchNet  # the model class of this module (``launch.steps.make_gnn_cell`` builds it)


def params_from_jax(cfg: SchNetConfig, tree: dict) -> dict[str, torch.Tensor]:
    """The state dict of :class:`SchNet` from the reference's tree (its
    ``interactions`` stacked on axis 0)."""
    return state_from_tree(tree, "interactions", cfg.n_interactions)


def forward(cfg: SchNetConfig, model: SchNet, batch: dict) -> torch.Tensor:
    """→ per-graph energies [n_graphs]."""
    n = batch["nodes"].shape[0]
    src, dst = batch["src"].long(), batch["dst"].long()
    emask = batch["edge_mask"].to(cfg.dtype)
    atom_types = batch["nodes"][:, 0].to(torch.int32).long()  # column 0 = Z

    pos = batch["positions"].to(cfg.dtype)
    dist = torch.sqrt(((pos.index_select(0, src) - pos.index_select(0, dst)) ** 2).sum(-1) + 1e-12)
    rbf = rbf_expand(dist, cfg.n_rbf, cfg.cutoff)
    # smooth cosine cutoff
    fcut = 0.5 * (torch.cos(math.pi * torch.clamp_max(dist / cfg.cutoff, 1.0)) + 1.0)

    h = model.embedding.index_select(0, atom_types)
    for block in model.interactions:
        w = block["filter"](rbf) * (fcut * emask)[:, None]
        x = block["in_proj"](h)
        agg = aggregate(x.index_select(0, src) * w, dst, n, "sum")  # continuous-filter conv
        h = h + block["out_mlp"](agg)
    atom_e = model.readout(h)[:, 0] * batch["node_mask"].to(cfg.dtype)
    return aggregate(atom_e, batch["graph_ids"], int(batch["n_graphs"]), "sum")


def loss_fn(cfg: SchNetConfig, model: SchNet, batch: dict) -> torch.Tensor:
    energy = forward(cfg, model, batch)
    return ((energy - batch["targets"]) ** 2).mean()
