"""GNN models (the reference's ``repro.models.gnn``): MeshGraphNet, PNA,
SchNet and GraphCast, and their shared MLP and message passing."""
from . import common, graphcast, meshgraphnet, pna, schnet
from .meshgraphnet import MGNConfig
from .graphcast import GraphCastConfig, multimesh_edges
from .pna import PNAConfig
from .schnet import SchNetConfig
