from .structure import (
    CSRGraph,
    Graph,
    GraphStats,
    build_graph,
    graph_from_arrays,
    pad_edges,
    resolve_device,
)
from .rmat import (
    clustered_graph,
    grid_graph,
    rmat_edges,
    rmat_graph,
    uniform_random_graph,
)
from . import partition
from .partition import GraphPartition, GraphShard, partition_graph

__all__ = [
    "CSRGraph", "Graph", "GraphStats", "build_graph", "graph_from_arrays",
    "pad_edges", "resolve_device",
    "rmat_edges", "rmat_graph", "uniform_random_graph", "grid_graph",
    "clustered_graph",
    "partition", "GraphPartition", "GraphShard", "partition_graph",
]
