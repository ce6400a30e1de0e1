"""graphcast [arXiv:2212.12794]: 16L d_hidden=512 mesh_refinement=6
aggregator=sum n_vars=227 (encoder-processor-decoder mesh GNN).
``make_cell`` waits with the cell programs of ``launch.steps``."""
from ..launch.steps import GNN_SHAPES
from ..models.gnn import graphcast as model

ARCH_ID = "graphcast"
FAMILY = "gnn"
SHAPES = list(GNN_SHAPES)


def make_config(shape: str = "full_graph_sm") -> model.GraphCastConfig:
    return model.GraphCastConfig(n_layers=16, d_hidden=512, mesh_refinement=6,
                                 n_vars=GNN_SHAPES[shape]["d_feat"], d_edge_in=4)


def make_smoke_config() -> model.GraphCastConfig:
    return model.GraphCastConfig(n_layers=2, d_hidden=32, mesh_refinement=1, n_vars=16, d_edge_in=4)
