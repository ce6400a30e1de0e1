"""GraphCast [arXiv:2212.12794]: encoder-processor-decoder mesh GNN.

Config: 16 processor layers, d_hidden=512, mesh refinement 6, 227 variables.

Faithful structure: grid→mesh encoder (one interaction block over grid2mesh
edges), a 16-layer processor on the multimesh, mesh→grid decoder. The
multimesh for refinement R is the union of the edge sets of icosahedron
subdivisions 0..R (``multimesh_edges``). When a batch provides a single
generic graph (the assigned shape grid), encoder/decoder run over that
graph's edges and the processor over the same edges — the degenerate
single-mesh case.

The reference's stacked ``processor`` is an ``nn.ModuleList`` run in a
Python loop; ``constrain`` and ``scan_unroll`` are dropped (one device),
and no rematerialisation is added (the reference has none).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
from torch import nn

from ...graph.structure import resolve_device, seeded_generator
from .common import MLP, aggregate, masked_mse, state_from_tree


@dataclasses.dataclass(frozen=True)
class GraphCastConfig:
    name: str = "graphcast"
    n_layers: int = 16
    d_hidden: int = 512
    mesh_refinement: int = 6
    n_vars: int = 227
    mlp_layers: int = 1
    aggregator: str = "sum"
    d_edge_in: int = 4
    dtype: Any = torch.float32


def multimesh_edges(refinement: int) -> tuple[np.ndarray, np.ndarray, int]:
    """Icosahedral multimesh: union of edges of subdivisions 0..refinement.

    Returns (src, dst, num_nodes). Subdivision splits each triangle in 4;
    midpoint vertices are shared via a cache (standard icosphere)."""
    t = (1.0 + 5 ** 0.5) / 2.0
    verts = [
        (-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0),
        (0, -1, t), (0, 1, t), (0, -1, -t), (0, 1, -t),
        (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1),
    ]
    faces = [
        (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
        (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
        (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
        (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
    ]
    verts = [np.asarray(v, np.float64) / np.linalg.norm(v) for v in verts]
    all_edges: set[tuple[int, int]] = set()

    def add_face_edges(fs):
        for a, b, c in fs:
            for u, v in ((a, b), (b, c), (c, a)):
                all_edges.add((u, v))
                all_edges.add((v, u))

    add_face_edges(faces)
    for _ in range(refinement):
        cache: dict[tuple[int, int], int] = {}

        def midpoint(a: int, b: int) -> int:
            key = (min(a, b), max(a, b))
            if key not in cache:
                m = verts[a] + verts[b]
                verts.append(m / np.linalg.norm(m))
                cache[key] = len(verts) - 1
            return cache[key]

        new_faces = []
        for a, b, c in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = new_faces
        add_face_edges(faces)
    src, dst = zip(*sorted(all_edges))
    return np.asarray(src, np.int32), np.asarray(dst, np.int32), len(verts)


def _sizes(cfg: GraphCastConfig, d_in: int, d_out: int | None = None) -> list[int]:
    return [d_in] + [cfg.d_hidden] * cfg.mlp_layers + [d_out or cfg.d_hidden]


class GraphCast(nn.Module):
    """The reference's ``init_params`` tree as modules, drawn from a
    ``torch.Generator`` seeded with ``seed`` on the model's device (the card
    unless the caller names another); :func:`params_from_jax` carries the
    reference's numbers across."""

    def __init__(self, cfg: GraphCastConfig, *, seed: int = 0, device=None):
        super().__init__()
        dev = resolve_device(device)
        gen = seeded_generator(dev, seed)
        d = cfg.d_hidden

        def mlp(sizes, **kw) -> MLP:
            return MLP(sizes, dtype=cfg.dtype, device=dev, generator=gen, **kw)

        def interaction() -> nn.ModuleDict:
            return nn.ModuleDict({"edge_mlp": mlp(_sizes(cfg, 3 * d)), "node_mlp": mlp(_sizes(cfg, 2 * d))})

        self.cfg = cfg
        self.grid_encoder = mlp(_sizes(cfg, cfg.n_vars))
        self.edge_encoder = mlp(_sizes(cfg, cfg.d_edge_in))
        self.g2m = interaction()
        self.m2g = interaction()
        self.decoder = mlp(_sizes(cfg, d, cfg.n_vars), layernorm=False)
        self.processor = nn.ModuleList(interaction() for _ in range(cfg.n_layers))


MODEL = GraphCast  # the model class of this module (``launch.steps.make_gnn_cell`` builds it)


def params_from_jax(cfg: GraphCastConfig, tree: dict) -> dict[str, torch.Tensor]:
    """The state dict of :class:`GraphCast` from the reference's tree (its
    ``processor`` stacked on axis 0)."""
    return state_from_tree(tree, "processor", cfg.n_layers)


def _interaction(block, h, e, src, dst, emask, n, aggregator):
    msg_in = torch.cat([e, h.index_select(0, src), h.index_select(0, dst)], dim=-1)
    e_new = e + block["edge_mlp"](msg_in) * emask
    agg = aggregate(e_new * emask, dst, n, aggregator)
    h_new = h + block["node_mlp"](torch.cat([h, agg], dim=-1))
    return h_new, e_new


def _take_local(h: torch.Tensor, dst_local: torch.Tensor, nodes_per_block: int) -> torch.Tensor:
    """The reference's ``take_along_axis(h.reshape(P, N/P, D),
    dst_local[..., None], axis=1)``: row ``dst_local`` of each edge's own
    block, -1 (and any id down to ``-N/P``) counted from the block's end,
    NaN for an id outside the block. Such an edge's message is dropped by
    the blocked sum, so the NaN stays in its own edge state, as in the
    reference. (An ``index_select`` of the flat rows: ``gather`` would keep
    each layer's ``h`` alive for its backward.)"""
    p, epb = dst_local.shape
    idx = torch.where(dst_local < 0, dst_local + nodes_per_block, dst_local).long()
    inside = (idx >= 0) & (idx < nodes_per_block)
    base = torch.arange(p, device=idx.device)[:, None] * nodes_per_block
    rows = h.index_select(0, (base + idx.clamp(0, nodes_per_block - 1)).reshape(-1)).reshape(p, epb, -1)
    return torch.where(inside[..., None], rows, torch.full_like(rows, float("nan")))


def _interaction_blocked(block, h, e, src, dst_local, emask, n_blocks, nodes_per_block, aggregator):
    """Owner-blocked interaction: edges arrive pre-partitioned by
    destination owner — src [P, Epb] global ids, dst_local [P, Epb] ∈
    [0, N/P). The scatter is a batched segment-sum: block ``p``'s edges add
    into its own ``N/P`` rows, and a ``dst_local`` outside ``[0, N/P)`` is
    dropped within its block (the flat row ``p * N/P + dst_local`` is used
    only for ids inside the block, so none spills into the next block)."""
    p, epb = src.shape
    d = h.shape[-1]
    h_src = h.index_select(0, src.reshape(-1).long()).reshape(p, epb, d)
    h_dst = _take_local(h, dst_local, nodes_per_block)
    msg_in = torch.cat([e, h_src, h_dst], dim=-1)
    e_new = e + block["edge_mlp"](msg_in) * emask
    inside = (dst_local >= 0) & (dst_local < nodes_per_block)
    base = torch.arange(p, device=dst_local.device)[:, None] * nodes_per_block
    flat = torch.where(inside, base + dst_local.long(), -1)
    agg = aggregate((e_new * emask).reshape(p * epb, d), flat.reshape(-1), n_blocks * nodes_per_block, "sum")
    h_new = h + block["node_mlp"](torch.cat([h, agg], dim=-1))
    return h_new, e_new


def forward_blocked(cfg: GraphCastConfig, model: GraphCast, batch: dict) -> torch.Tensor:
    """Owner-blocked forward: batch carries src [P, Epb], dst_local [P, Epb],
    edge_mask [P, Epb]; nodes [N, F] with P | N."""
    n = batch["nodes"].shape[0]
    p = batch["src"].shape[0]
    npb = n // p
    src, dstl = batch["src"], batch["dst_local"]
    emask = batch["edge_mask"][..., None].to(cfg.dtype)

    def interaction(block, h, e):
        return _interaction_blocked(block, h, e, src, dstl, emask, p, npb, cfg.aggregator)

    h = model.grid_encoder(batch["nodes"].to(cfg.dtype))
    e = model.edge_encoder(batch["edge_feat"].to(cfg.dtype)) * emask
    h, e = interaction(model.g2m, h, e)
    for block in model.processor:
        h, e = interaction(block, h, e)
    h, _ = interaction(model.m2g, h, e)
    return model.decoder(h)


def loss_fn_blocked(cfg: GraphCastConfig, model: GraphCast, batch: dict) -> torch.Tensor:
    pred = forward_blocked(cfg, model, batch)
    return masked_mse(pred, batch["targets"], batch["node_mask"].float())


def forward(cfg: GraphCastConfig, model: GraphCast, batch: dict) -> torch.Tensor:
    """Single-mesh path: encoder → 16-layer processor → decoder, all on the
    batch's edge set. → per-node [N, n_vars]."""
    n = batch["nodes"].shape[0]
    src, dst = batch["src"].long(), batch["dst"].long()
    emask = batch["edge_mask"][:, None].to(cfg.dtype)

    h = model.grid_encoder(batch["nodes"].to(cfg.dtype))
    e = model.edge_encoder(batch["edge_feat"].to(cfg.dtype)) * emask
    h, e = _interaction(model.g2m, h, e, src, dst, emask, n, cfg.aggregator)
    for block in model.processor:
        h, e = _interaction(block, h, e, src, dst, emask, n, cfg.aggregator)
    h, _ = _interaction(model.m2g, h, e, src, dst, emask, n, cfg.aggregator)
    return model.decoder(h)


def loss_fn(cfg: GraphCastConfig, model: GraphCast, batch: dict) -> torch.Tensor:
    pred = forward(cfg, model, batch)
    return masked_mse(pred, batch["targets"], batch["node_mask"].float())
