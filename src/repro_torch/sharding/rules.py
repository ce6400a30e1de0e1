"""Logical-axis sharding rules → partition specs and trees of them (the
reference's ``repro.sharding.rules``).

Models annotate every param/activation dim with a *logical* name; a rule
table maps logical names to mesh axes. Divisibility is checked against the
actual dim size — an indivisible mapping silently degrades to replication
(e.g. granite's single KV head cannot shard over a 16-way 'model' axis).

Rule tables:
  batch        → (pod,) data   — data parallel
  vocab/heads/kv_heads/mlp/experts → model — tensor/expert parallel
  embed        → data          — FSDP (ZeRO-3) parameter + optimizer sharding
  edges/nodes/candidates/rows  → full flatten — graph & table sharding

A spec is a plain tuple with one entry per dim, each ``None``, a mesh axis
name or a tuple of names: the entries of the reference's ``PartitionSpec``
(``()`` for a replicated array). A mesh is anything with ``axis_names`` and
a name → size ``shape`` (``launch.mesh.Mesh``); the plan is arithmetic over
those two, so it needs no devices.
"""
from __future__ import annotations

import math
from typing import Any

from .._tree import tree_map


def default_rules(mesh) -> dict[str, tuple[str, ...] | None]:
    multi_pod = "pod" in mesh.axis_names
    batch = ("pod", "data") if multi_pod else ("data",)
    flat = ("pod", "data", "model") if multi_pod else ("data", "model")
    return {
        # activations
        "batch": batch,
        "seq": None,
        "seq_sp": ("model",),   # sequence parallelism
        "cache_seq": None,
        "embed_act": None,
        # LM params
        "vocab": ("model",),
        "embed": ("data",),          # FSDP
        "embed_nope": None,
        "heads": ("model",),
        "kv_heads": ("model",),
        "head_dim": None,
        "mlp": ("model",),
        "experts": ("model",),
        "experts_nope": None,
        "layers": None,
        # GNN / graph engine
        "edges": flat,
        "edge_blocks": flat,   # owner-blocked edge partitions
        "nodes": flat,
        "gnn_in": None,
        # recsys
        "rows": flat,                # embedding-table rows
        "items_batch": ("model",),   # in-batch softmax column axis
        "candidates": flat,
        "fields": None,
    }


def spec_for(axes: tuple | None, shape: tuple[int, ...], mesh, rules: dict) -> tuple:
    """The partition spec of one array given its logical axes and shape:
    each dim takes its rule's mesh axes that are on the mesh and not taken
    by an earlier dim, cut to the longest prefix whose size divides the dim,
    or none (replicated) when no prefix does."""
    if axes is None:
        return ()
    assert len(axes) == len(shape), f"axes {axes} vs shape {shape}"
    used: set[str] = set()
    parts: list[Any] = []
    for ax_name, dim in zip(axes, shape):
        mesh_axes = rules.get(ax_name) if ax_name is not None else None
        if not mesh_axes:
            parts.append(None)
            continue
        mesh_axes = tuple(a for a in mesh_axes if a in mesh.axis_names and a not in used)
        if not mesh_axes:
            parts.append(None)
            continue
        total = math.prod(mesh.shape[a] for a in mesh_axes)
        if dim % total != 0:
            # try a prefix that divides
            while mesh_axes and dim % math.prod(mesh.shape[a] for a in mesh_axes) != 0:
                mesh_axes = mesh_axes[:-1]
            if not mesh_axes:
                parts.append(None)
                continue
        used.update(mesh_axes)
        parts.append(mesh_axes if len(mesh_axes) > 1 else mesh_axes[0])
    return tuple(parts)


def sharding_tree(abstract_tree: Any, axes_tree: Any, mesh, rules: dict | None = None) -> Any:
    """Tree of specs matching ``abstract_tree`` (nested dicts and lists of
    tensors, meta or not); ``axes_tree`` holds a tuple of logical names (or
    ``None``) at each of its leaves."""
    rules = rules or default_rules(mesh)

    def one(leaf, axes):
        return spec_for(tuple(axes) if axes is not None else None, tuple(leaf.shape), mesh, rules)

    return tree_map(one, abstract_tree, axes_tree)


def replicated_tree(abstract_tree: Any, mesh) -> Any:
    return tree_map(lambda _: (), abstract_tree)
