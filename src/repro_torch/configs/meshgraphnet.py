"""meshgraphnet [arXiv:2010.03409]: 15L d_hidden=128 sum-agg mlp_layers=2.
``make_cell`` waits with the cell programs of ``launch.steps``."""
from ..launch.steps import GNN_SHAPES
from ..models.gnn import meshgraphnet as model

ARCH_ID = "meshgraphnet"
FAMILY = "gnn"
SHAPES = list(GNN_SHAPES)


def make_config(shape: str = "full_graph_sm") -> model.MGNConfig:
    d_feat = GNN_SHAPES[shape]["d_feat"]
    return model.MGNConfig(n_layers=15, d_hidden=128, mlp_layers=2,
                           aggregator="sum", d_node_in=d_feat, d_edge_in=8, d_out=3)


def make_smoke_config() -> model.MGNConfig:
    return model.MGNConfig(n_layers=2, d_hidden=32, d_node_in=16, d_edge_in=8, d_out=3)
