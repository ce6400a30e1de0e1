"""Arch registry: --arch <id> selection for launchers, dry-run and tests
(the reference's ``repro.configs.registry``: the ten assigned archs and the
paper's own graph-engine workload)."""
from __future__ import annotations

from importlib import import_module

_MODULES = {
    "granite-34b": "granite_34b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "stablelm-1.6b": "stablelm_1_6b",
    "grok-1-314b": "grok_1_314b",
    "arctic-480b": "arctic_480b",
    "meshgraphnet": "meshgraphnet",
    "pna": "pna",
    "graphcast": "graphcast",
    "schnet": "schnet",
    "two-tower-retrieval": "two_tower_retrieval",
    "paper-graph-engine": "paper_graph_engine",
}

ASSIGNED_ARCHS = [a for a in _MODULES if a != "paper-graph-engine"]


def get_arch(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {list(_MODULES)}")
    return import_module(f"{__package__}.{_MODULES[arch_id]}")


def arch_shapes(arch_id: str) -> list[str]:
    mod = get_arch(arch_id)
    if hasattr(mod, "SHAPES"):
        return list(mod.SHAPES)
    from ..launch.steps import LM_SHAPES
    return list(LM_SHAPES)


def all_cells() -> list[tuple[str, str]]:
    return [(a, s) for a in ASSIGNED_ARCHS for s in arch_shapes(a)]
