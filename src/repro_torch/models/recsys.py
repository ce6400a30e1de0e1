"""Two-tower retrieval model [Yi et al., RecSys'19].

embed_dim=256, tower MLPs 1024-512-256, dot-product interaction, in-batch
sampled softmax with logQ correction. Features per side are categorical
fields, each looked up in its embedding table through an EmbeddingBag
(``layers.embedding``, the hand-written kernel on the card, under
autograd through ``EmbeddingBagFunction``); the towers' matrix products
stay ``nn.Linear``, as the reference leaves them to XLA. Candidates are
scored through ``kernels.scoring``.

The module-level functions keep the reference's names and signatures with
a :class:`TwoTower` in place of the parameter tree, and carry gradients;
the model's serving methods run without them. :func:`params_tree` gives
the reference's tree as views of the parameters (and their ``.grad``s),
so an in-place optimizer update lands in the model. The reference's
``constrain`` (activation sharding) has no counterpart: the port runs on
one device.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
from torch import nn

from ..graph.structure import resolve_device, seeded_generator
from ..kernels.scoring import score_topk
from ..layers.embedding import embedding_bag
from .gnn.common import MLP, mlp_state_from_jax


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    name: str
    vocab: int
    multi_hot: int = 1  # ids per bag (fixed hot-size; masked by weight 0)


@dataclasses.dataclass(frozen=True)
class TwoTowerConfig:
    name: str = "two-tower-retrieval"
    embed_dim: int = 256
    tower_mlp: tuple = (1024, 512, 256)
    user_fields: tuple = (
        FieldSpec("user_id", 10_000_000),
        FieldSpec("user_history", 1_000_000, multi_hot=32),
        FieldSpec("user_geo", 100_000),
    )
    item_fields: tuple = (
        FieldSpec("item_id", 10_000_000),
        FieldSpec("item_category", 10_000),
        FieldSpec("item_tags", 100_000, multi_hot=8),
    )
    temperature: float = 0.05
    dtype: Any = torch.float32


class TwoTower(nn.Module):
    """Both towers and their tables, initialised as the reference's
    ``init_params`` does (tables normal * 0.01, MLP weights normal *
    fan_in**-0.5, biases zero) from a ``torch.Generator`` seeded with
    ``seed`` on the model's device. The numbers differ from the reference's
    (another generator); :func:`params_from_jax` carries those across."""

    def __init__(self, cfg: TwoTowerConfig, *, seed: int = 0, device=None):
        super().__init__()
        dev = resolve_device(device)
        gen = seeded_generator(dev, seed)
        self.cfg = cfg

        def tables(fields) -> nn.ParameterDict:
            return nn.ParameterDict({
                f.name: nn.Parameter(
                    torch.empty(f.vocab, cfg.embed_dim, dtype=cfg.dtype, device=dev)
                    .normal_(generator=gen).mul_(0.01)
                )
                for f in fields
            })

        def tower(fields) -> MLP:
            sizes = [len(fields) * cfg.embed_dim, *cfg.tower_mlp]
            return MLP(sizes, layernorm=False, dtype=cfg.dtype, device=dev, generator=gen)

        self.user_tables = tables(cfg.user_fields)
        self.item_tables = tables(cfg.item_fields)
        self.user_tower = tower(cfg.user_fields)
        self.item_tower = tower(cfg.item_fields)

    @torch.no_grad()
    def user_embedding(self, feats: dict, batch: int) -> torch.Tensor:
        return user_embedding(self.cfg, self, feats, batch)

    @torch.no_grad()
    def item_embedding(self, feats: dict, batch: int) -> torch.Tensor:
        return item_embedding(self.cfg, self, feats, batch)

    @torch.no_grad()
    def score_candidates(self, user_feats: dict, item_emb_matrix: torch.Tensor, *, top_k: int = 100):
        """retrieval_cand: queries against a precomputed candidate matrix
        ``[n_candidates, D]`` → (scores, indices) of the top-k per query,
        scores divided by the temperature. Dividing the selected scores
        gives the reference's elements (``(u @ C.T) / T``, then top-k),
        since ``T > 0`` keeps the order."""
        b = next(iter(user_feats.values())).shape[0]
        u = self.user_embedding(user_feats, b)
        vals, idx = score_topk(u, item_emb_matrix, top_k)
        return vals / self.cfg.temperature, idx


def _tower(cfg: TwoTowerConfig, tables, tower: MLP, feats: dict, fields, batch: int) -> torch.Tensor:
    cols = []
    for f in fields:
        ids = feats[f.name]                      # [B, multi_hot] int
        weights = feats.get(f.name + "_w")       # [B, multi_hot] float or None
        segs = torch.arange(batch, dtype=torch.int32, device=ids.device)
        segs = segs.repeat_interleave(f.multi_hot)
        cols.append(embedding_bag(
            tables[f.name], ids.reshape(-1), segs, batch, mode="sum",
            weights=None if weights is None else weights.reshape(-1),
        ))
    out = tower(torch.cat(cols, dim=-1))
    return out / torch.linalg.vector_norm(out, dim=-1, keepdim=True).clamp_min(1e-6)


def user_embedding(cfg: TwoTowerConfig, model: TwoTower, feats: dict, batch: int) -> torch.Tensor:
    return _tower(cfg, model.user_tables, model.user_tower, feats, cfg.user_fields, batch)


def item_embedding(cfg: TwoTowerConfig, model: TwoTower, feats: dict, batch: int) -> torch.Tensor:
    return _tower(cfg, model.item_tables, model.item_tower, feats, cfg.item_fields, batch)


def loss_fn(cfg: TwoTowerConfig, model: TwoTower, batch: dict) -> torch.Tensor:
    """In-batch sampled softmax with logQ correction, a float32 mean.

    batch: {user: {field: ids}, item: {field: ids}, log_q: [B]}"""
    b = batch["log_q"].shape[0]
    u = user_embedding(cfg, model, batch["user"], b)       # [B, D]
    v = item_embedding(cfg, model, batch["item"], b)       # [B, D]
    logits = (u @ v.T) / cfg.temperature                   # [B, B]
    logits = (logits - batch["log_q"][None, :]).float()    # logQ correction
    logz = torch.logsumexp(logits, dim=-1)
    return (logz - logits.diagonal()).mean()


def params_tree(model: TwoTower, *, grads: bool = False) -> dict:
    """The reference's ``init_params`` tree of ``model`` (``grads``: of its
    ``.grad``s, zeros where none): ``user_tables``, ``item_tables``,
    ``user_tower``, ``item_tower``, each tower weight as ``[in, out]``.
    The leaves are views of the parameters, not copies (a tower weight is
    its parameter transposed), so writing into them writes the model."""
    def leaf(p: torch.Tensor) -> torch.Tensor:
        if not grads:
            return p.detach()
        return p.grad if p.grad is not None else torch.zeros_like(p)

    def tower(mlp: MLP) -> dict:
        return {"layers": [{"w": leaf(l.weight).T, "b": leaf(l.bias)} for l in mlp.layers]}

    cfg = model.cfg
    return {"user_tables": {f.name: leaf(model.user_tables[f.name]) for f in cfg.user_fields},
            "item_tables": {f.name: leaf(model.item_tables[f.name]) for f in cfg.item_fields},
            "user_tower": tower(model.user_tower), "item_tower": tower(model.item_tower)}


def init_params(cfg: TwoTowerConfig, *, seed: int = 0, device=None) -> dict:
    """The reference's ``init_params`` tree (tables normal * 0.01, tower
    weights normal * fan_in**-0.5, biases zero), drawn as :class:`TwoTower`
    draws them from ``seed`` on ``device`` (the card unless the caller
    names another)."""
    return params_tree(TwoTower(cfg, seed=seed, device=device))


def params_from_jax(cfg: TwoTowerConfig, tree: dict) -> dict[str, torch.Tensor]:
    """The state dict of :class:`TwoTower` holding the numbers of the
    reference's ``init_params(cfg, key)`` tree, given as nested dicts of
    numpy arrays; load it with ``model.load_state_dict``."""
    state: dict[str, torch.Tensor] = {}
    for side, fields in (("user", cfg.user_fields), ("item", cfg.item_fields)):
        for f in fields:
            state[f"{side}_tables.{f.name}"] = torch.from_numpy(np.array(tree[f"{side}_tables"][f.name]))
        for k, v in mlp_state_from_jax(tree[f"{side}_tower"]).items():
            state[f"{side}_tower.{k}"] = v
    return state
