"""Shared helpers for the dry-run slice's parity tests: the cells of both
packages (every assigned cell, the graph engine's two, and the variants the
reference's dry-run takes) and their trees flattened into comparable
``(path, value)`` lists, paths as the port's ``_tree.tree_paths`` writes
them (dict keys sorted, list and tuple positions, joined by ``/``)."""
from __future__ import annotations

GRAPH_CELLS = [("paper-graph-engine", "pr_iteration"), ("paper-graph-engine", "bfs_expand")]
LM_ARCHS = ["granite-34b", "tinyllama-1.1b", "stablelm-1.6b", "grok-1-314b", "arctic-480b"]
LM_SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
GNN_SHAPES = ["full_graph_sm", "minibatch_lg", "ogb_products", "molecule"]
# the reference dry-run's --variant values: MoE dispatch, GraphCast's
# owner-blocked layout, sequence parallelism
VARIANTS = (
    [(a, s, {"dispatch": "gather"}) for a in ("grok-1-314b", "arctic-480b") for s in LM_SHAPES]
    + [("graphcast", s, {"blocked": True}) for s in GNN_SHAPES]
    + [(a, s, {"seq_parallel": True}) for a in LM_ARCHS for s in LM_SHAPES]
)


def all_cell_ids() -> list[tuple[str, str]]:
    from repro.configs import all_cells

    return all_cells() + GRAPH_CELLS


def dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def jax_paths(tree, is_leaf=None) -> list[tuple[str, object]]:
    import jax

    def key(k) -> str:
        for attr in ("key", "idx", "name"):
            if hasattr(k, attr):
                return str(getattr(k, attr))
        raise TypeError(k)

    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)
    return [("/".join(key(k) for k in path), leaf) for path, leaf in flat]


def shapes(pairs) -> list[tuple[str, tuple, str]]:
    return [(p, tuple(int(d) for d in leaf.shape), dtype_name(leaf.dtype)) for p, leaf in pairs]


def jax_shapes(tree) -> list[tuple[str, tuple, str]]:
    return shapes(jax_paths(tree, is_leaf=lambda x: hasattr(x, "shape") and hasattr(x, "dtype")))


def port_shapes(tree) -> list[tuple[str, tuple, str]]:
    from repro_torch._tree import tree_paths

    return shapes(tree_paths(list(tree) if isinstance(tree, tuple) else tree))


def jax_axes(tree) -> list[tuple[str, tuple]]:
    return jax_paths(tree, is_leaf=lambda x: isinstance(x, tuple))


def port_axes(tree) -> list[tuple[str, tuple]]:
    from repro_torch._tree import tree_paths

    return tree_paths(tree)


def jax_plan(tree) -> list[tuple[str, tuple]]:
    from jax.sharding import NamedSharding

    return [(p, tuple(ns.spec)) for p, ns in jax_paths(tree, is_leaf=lambda x: isinstance(x, NamedSharding))]


def abstract_meshes():
    """The reference's two production layouts as ``AbstractMesh`` (no
    devices) beside the port's plans of them."""
    from jax.sharding import AbstractMesh

    from repro_torch.launch.mesh import make_production_mesh

    return [
        (AbstractMesh((16, 16), ("data", "model")), make_production_mesh()),
        (AbstractMesh((2, 16, 16), ("pod", "data", "model")), make_production_mesh(multi_pod=True)),
    ]


def make_cells(arch: str, shape: str, **kwargs):
    """(the reference's cell, the port's) for one id."""
    from repro.configs import get_arch as jax_arch

    from repro_torch.configs import get_arch

    return jax_arch(arch).make_cell(shape, **kwargs), get_arch(arch).make_cell(shape, **kwargs)


def make_trip1(mod, shape: str):
    """The dry-run's trip-1 variant of a cell (one layer, one microbatch)."""
    try:
        return mod.make_cell(shape, n_layers_override=1, microbatches_override=1)
    except TypeError:
        return mod.make_cell(shape, n_layers_override=1)
