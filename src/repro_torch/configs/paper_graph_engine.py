"""The paper's own workload as an 11th config: a PageRank-pull iteration
and a BFS frontier expansion over an RMAT-scale graph, planned
edge-parallel over the mesh (the graph-engine data path the scheduler
controls). At full scale, V = 2^26 and E = 2^30: the arguments take
8.5 GiB, so one card holds them.

The steps keep the reference's semantics: ``jnp.take`` (an id in ``[-V,
0)`` wrapped, any other id outside ``[0, V)`` reading NaN, or True from a
boolean frontier), then ``segment_sum`` (a target outside ``[0, V)``
dropped) or ``.at[dst].max(..., mode="drop")`` (a target in ``[-V, 0)``
wrapped, any other dropped). Tensor ops only, no boolean masking: the
steps also run on ``meta`` for the dry-run."""
import torch

from ..kernels.embedding_bag.embedding_bag import bag_index, wrap_ids
from ..launch.steps import CellProgram, META
from ..sharding.context import constrain

ARCH_ID = "paper-graph-engine"
FAMILY = "graph"
SHAPES = ["pr_iteration", "bfs_expand"]

V = 1 << 26
E = 1 << 30


def _take(x: torch.Tensor, ids: torch.Tensor, fill) -> torch.Tensor:
    """``jnp.take(x, ids)`` on a vector: ``fill`` where an id reads no entry."""
    row, inside = wrap_ids(ids, x.shape[0])
    return torch.where(inside, x[row], fill)


def pr_step(src: torch.Tensor, dst: torch.Tensor, rank: torch.Tensor, out_deg: torch.Tensor) -> torch.Tensor:
    contrib = torch.where(out_deg > 0, rank / torch.clamp_min(out_deg, 1), 0.0)
    vals = constrain(_take(contrib, src, torch.nan), ("edges",))
    acc = torch.zeros(V + 1, dtype=vals.dtype, device=vals.device).index_add_(0, bag_index(dst, V), vals)[:V]
    return 0.15 / V + 0.85 * acc


def bfs_step(src: torch.Tensor, dst: torch.Tensor, visited: torch.Tensor, frontier: torch.Tensor):
    active = constrain(_take(frontier, src, True), ("edges",))
    row, inside = wrap_ids(dst, V)
    # booleans take no scatter_reduce: count the active in-edges in int32
    hits = torch.zeros(V + 1, dtype=torch.int32, device=active.device)
    hits.index_add_(0, torch.where(inside, row, V), active.to(torch.int32))
    new = (hits[:V] > 0) & ~visited
    return visited | new, new


def make_cell(shape: str, **_):
    if shape == "pr_iteration":
        args = (
            torch.empty(E, dtype=torch.int32, device=META),
            torch.empty(E, dtype=torch.int32, device=META),
            torch.empty(V, dtype=torch.float32, device=META),
            torch.empty(V, dtype=torch.int32, device=META),
        )
        axes = (("edges",), ("edges",), ("nodes",), ("nodes",))
        return CellProgram(
            name=f"{ARCH_ID}:{shape}", kind="serve", step_fn=pr_step,
            abstract_args=args, axes_trees=axes,
            meta=dict(model_flops=2.0 * E, n_edges=E, n_nodes=V),
        )

    args = (
        torch.empty(E, dtype=torch.int32, device=META),
        torch.empty(E, dtype=torch.int32, device=META),
        torch.empty(V, dtype=torch.bool, device=META),
        torch.empty(V, dtype=torch.bool, device=META),
    )
    axes = (("edges",), ("edges",), ("nodes",), ("nodes",))
    return CellProgram(
        name=f"{ARCH_ID}:{shape}", kind="serve", step_fn=bfs_step,
        abstract_args=args, axes_trees=axes,
        meta=dict(model_flops=1.0 * E, n_edges=E, n_nodes=V),
    )
