"""meshgraphnet [arXiv:2010.03409]: 15L d_hidden=128 sum-agg mlp_layers=2."""
import dataclasses

from ..launch.steps import GNN_SHAPES, make_gnn_cell
from ..models.gnn import meshgraphnet as model
from ..optim import OptimizerConfig

ARCH_ID = "meshgraphnet"
FAMILY = "gnn"
SHAPES = list(GNN_SHAPES)


def make_config(shape: str = "full_graph_sm") -> model.MGNConfig:
    d_feat = GNN_SHAPES[shape]["d_feat"]
    return model.MGNConfig(n_layers=15, d_hidden=128, mlp_layers=2,
                           aggregator="sum", d_node_in=d_feat, d_edge_in=8, d_out=3)


def make_smoke_config() -> model.MGNConfig:
    return model.MGNConfig(n_layers=2, d_hidden=32, d_node_in=16, d_edge_in=8, d_out=3)


def make_cell(shape: str, *, n_layers_override=None, **_):
    cfg = make_config(shape)
    if n_layers_override is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers_override)
    return make_gnn_cell(ARCH_ID, model, cfg, shape, OptimizerConfig(name="adamw"),
                         d_edge=8, d_target=3)
