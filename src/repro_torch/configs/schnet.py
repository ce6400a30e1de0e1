"""schnet [arXiv:1706.08566]: 3 interactions d_hidden=64 rbf=300 cutoff=10."""
import dataclasses

from ..launch.steps import GNN_SHAPES, make_gnn_cell
from ..models.gnn import schnet as model
from ..optim import OptimizerConfig

ARCH_ID = "schnet"
FAMILY = "gnn"
SHAPES = list(GNN_SHAPES)


def make_config(shape: str = "molecule") -> model.SchNetConfig:
    return model.SchNetConfig(n_interactions=3, d_hidden=64, n_rbf=300, cutoff=10.0)


def make_smoke_config() -> model.SchNetConfig:
    return model.SchNetConfig(n_interactions=2, d_hidden=16, n_rbf=20)


def make_cell(shape: str, *, n_layers_override=None, **_):
    cfg = make_config(shape)
    if n_layers_override is not None:
        cfg = dataclasses.replace(cfg, n_interactions=n_layers_override)
    return make_gnn_cell(ARCH_ID, model, cfg, shape, OptimizerConfig(name="adamw"),
                         d_edge=1, d_target=1, with_positions=True, per_graph_target=True)
