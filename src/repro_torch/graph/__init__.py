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
from .datasets import load_dataset, all_dataset_names, SNAP_SPECS
from .epochs import GraphEpochLog
from .sampler import (
    DegreeStatTracker,
    SampledBlock,
    block_to_device,
    plan_capacity,
    sample_fanout,
)
from . import partition
from .partition import GraphPartition, GraphShard, partition_graph

__all__ = [
    "CSRGraph", "Graph", "GraphStats", "build_graph", "graph_from_arrays",
    "pad_edges", "resolve_device",
    "rmat_edges", "rmat_graph", "uniform_random_graph", "grid_graph",
    "clustered_graph",
    "load_dataset", "all_dataset_names", "SNAP_SPECS",
    "GraphEpochLog", "DegreeStatTracker",
    "sample_fanout", "plan_capacity", "SampledBlock", "block_to_device",
    "partition", "GraphPartition", "GraphShard", "partition_graph",
]
