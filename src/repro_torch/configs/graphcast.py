"""graphcast [arXiv:2212.12794]: 16L d_hidden=512 mesh_refinement=6
aggregator=sum n_vars=227 (encoder-processor-decoder mesh GNN)."""
import dataclasses

from ..launch.steps import GNN_SHAPES, make_gnn_cell
from ..models.gnn import graphcast as model
from ..optim import OptimizerConfig

ARCH_ID = "graphcast"
FAMILY = "gnn"
SHAPES = list(GNN_SHAPES)


def make_config(shape: str = "full_graph_sm") -> model.GraphCastConfig:
    return model.GraphCastConfig(n_layers=16, d_hidden=512, mesh_refinement=6,
                                 n_vars=GNN_SHAPES[shape]["d_feat"], d_edge_in=4)


def make_smoke_config() -> model.GraphCastConfig:
    return model.GraphCastConfig(n_layers=2, d_hidden=32, mesh_refinement=1, n_vars=16, d_edge_in=4)


def make_cell(shape: str, *, n_layers_override=None, blocked: bool = False, **_):
    cfg = make_config(shape)
    if n_layers_override is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers_override)
    return make_gnn_cell(ARCH_ID, model, cfg, shape, OptimizerConfig(name="adamw"),
                         d_edge=4, d_target=GNN_SHAPES[shape]["d_feat"], blocked=blocked)
