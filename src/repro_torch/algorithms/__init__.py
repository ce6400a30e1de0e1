from .bfs import BFSExecutor, DirectionOptimizedBFSExecutor, bfs_reference
from .pagerank import PageRankExecutor, pagerank_reference, DAMPING
from .degree_count import DegreeCountExecutor, degree_count_reference, PACKAGE_EDGES
from .common import EdgeArrays, compact_frontier, member_mask_from_slots, merge_ranges

__all__ = [
    "BFSExecutor", "DirectionOptimizedBFSExecutor", "bfs_reference",
    "PageRankExecutor", "pagerank_reference", "DAMPING",
    "DegreeCountExecutor", "degree_count_reference", "PACKAGE_EDGES",
    "EdgeArrays", "compact_frontier", "member_mask_from_slots", "merge_ranges",
]
