"""schnet [arXiv:1706.08566]: 3 interactions d_hidden=64 rbf=300 cutoff=10.
``make_cell`` waits with the cell programs of ``launch.steps``."""
from ..launch.steps import GNN_SHAPES
from ..models.gnn import schnet as model

ARCH_ID = "schnet"
FAMILY = "gnn"
SHAPES = list(GNN_SHAPES)


def make_config(shape: str = "molecule") -> model.SchNetConfig:
    return model.SchNetConfig(n_interactions=3, d_hidden=64, n_rbf=300, cutoff=10.0)


def make_smoke_config() -> model.SchNetConfig:
    return model.SchNetConfig(n_interactions=2, d_hidden=16, n_rbf=20)
