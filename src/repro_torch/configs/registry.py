"""Arch registry over the configs ported so far. The reference's registry
(``repro.configs.registry``) knows eleven archs; an arch not ported yet
(``paper-graph-engine``) raises ``KeyError`` naming the ones that are."""
from __future__ import annotations

from importlib import import_module

_MODULES = {
    "granite-34b": "granite_34b",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "stablelm-1.6b": "stablelm_1_6b",
    "two-tower-retrieval": "two_tower_retrieval",
    "grok-1-314b": "grok_1_314b",
    "arctic-480b": "arctic_480b",
    "meshgraphnet": "meshgraphnet",
    "graphcast": "graphcast",
    "pna": "pna",
    "schnet": "schnet",
}

PORTED_ARCHS = list(_MODULES)


def get_arch(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"arch {arch_id!r} is not ported; ported: {PORTED_ARCHS}")
    return import_module(f"{__package__}.{_MODULES[arch_id]}")
