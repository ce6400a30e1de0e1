"""pna [arXiv:2004.05718]: 4L d_hidden=75, aggregators mean-max-min-std,
scalers identity-amplification-attenuation."""
import dataclasses

from ..launch.steps import GNN_SHAPES, make_gnn_cell
from ..models.gnn import pna as model
from ..optim import OptimizerConfig

ARCH_ID = "pna"
FAMILY = "gnn"
SHAPES = list(GNN_SHAPES)


def make_config(shape: str = "full_graph_sm") -> model.PNAConfig:
    return model.PNAConfig(n_layers=4, d_hidden=75,
                           d_node_in=GNN_SHAPES[shape]["d_feat"], n_classes=64)


def make_smoke_config() -> model.PNAConfig:
    return model.PNAConfig(n_layers=2, d_hidden=24, d_node_in=16, n_classes=5)


def make_cell(shape: str, *, n_layers_override=None, **_):
    cfg = make_config(shape)
    if n_layers_override is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers_override)
    return make_gnn_cell(ARCH_ID, model, cfg, shape, OptimizerConfig(name="adamw"),
                         d_edge=1, d_target=1, int_targets=True)
