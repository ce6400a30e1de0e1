"""pna [arXiv:2004.05718]: 4L d_hidden=75, aggregators mean-max-min-std,
scalers identity-amplification-attenuation. ``make_cell`` waits with the
cell programs of ``launch.steps``."""
from ..launch.steps import GNN_SHAPES
from ..models.gnn import pna as model

ARCH_ID = "pna"
FAMILY = "gnn"
SHAPES = list(GNN_SHAPES)


def make_config(shape: str = "full_graph_sm") -> model.PNAConfig:
    return model.PNAConfig(n_layers=4, d_hidden=75,
                           d_node_in=GNN_SHAPES[shape]["d_feat"], n_classes=64)


def make_smoke_config() -> model.PNAConfig:
    return model.PNAConfig(n_layers=2, d_hidden=24, d_node_in=16, n_classes=5)
