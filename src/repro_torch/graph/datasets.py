"""Synthetic surrogates for the paper's real-world data sets.

The paper evaluates on 7 SNAP graphs. This repository ships no data, so it
builds *surrogates*: generators matched on |V|, |E| and degree family
(power-law for social/web graphs, near-constant for road networks). Every
surrogate is flagged ``surrogate=True`` and scaled down by ``scale_div``
(``scale_div=1`` gives the full size). The same arguments give the same
graph as the JAX package's ``load_dataset``.

Reference statistics (SNAP, for the record):
  soc-LiveJournal1        4,847,571 V    68,993,773 E   power-law
  as-skitter              1,696,415 V    11,095,298 E   power-law
  roadNet-CA              1,965,206 V     2,766,607 E   ~constant degree
  cit-Patents             3,774,768 V    16,518,948 E   power-law (citation DAG)
  roadNet-PA              1,088,092 V     1,541,898 E   ~constant degree
  web-BerkStan              685,230 V     7,600,595 E   power-law (web)
  soc-pokec-relationships 1,632,803 V    30,622,564 E   power-law
"""
from __future__ import annotations

import dataclasses
import math

from .rmat import grid_graph, rmat_edges
from .structure import Graph, build_graph


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    num_vertices: int
    num_edges: int
    family: str  # "power_law" | "road"


SNAP_SPECS = {
    "soc-LiveJournal1": DatasetSpec("soc-LiveJournal1", 4_847_571, 68_993_773, "power_law"),
    "as-skitter": DatasetSpec("as-skitter", 1_696_415, 11_095_298, "power_law"),
    "roadNet-CA": DatasetSpec("roadNet-CA", 1_965_206, 2_766_607, "road"),
    "cit-Patents": DatasetSpec("cit-Patents", 3_774_768, 16_518_948, "power_law"),
    "roadNet-PA": DatasetSpec("roadNet-PA", 1_088_092, 1_541_898, "road"),
    "web-BerkStan": DatasetSpec("web-BerkStan", 685_230, 7_600_595, "power_law"),
    "soc-pokec-relationships": DatasetSpec("soc-pokec-relationships", 1_632_803, 30_622_564, "power_law"),
}


def _power_law_surrogate(spec: DatasetSpec, scale_div: int, seed: int, device) -> Graph:
    """RMAT with scale/edge-factor matched to the target V, E."""
    v = max(spec.num_vertices // scale_div, 1 << 10)
    e = max(spec.num_edges // scale_div, 1 << 12)
    scale = max(int(round(math.log2(v))), 10)
    edge_factor = max(int(round(e / (1 << scale))), 1)
    src, dst = rmat_edges(scale, edge_factor, seed=seed)
    return build_graph(src, dst, 1 << scale, name=spec.name, surrogate=True, device=device)


def _road_surrogate(spec: DatasetSpec, scale_div: int, device) -> Graph:
    v = max(spec.num_vertices // scale_div, 1 << 10)
    side = max(int(math.sqrt(v)), 32)
    g = grid_graph(side, name=spec.name, device=device)
    return dataclasses.replace(g, surrogate=True)


def load_dataset(name: str, *, scale_div: int = 64, seed: int = 0, device=None) -> Graph:
    """Build the surrogate for a named SNAP dataset on ``device`` (the card
    unless the caller names another).

    ``scale_div`` scales down vertex/edge counts; 1 gives the full size.
    """
    spec = SNAP_SPECS.get(name)
    if spec is None:
        raise KeyError(f"unknown dataset {name!r}; known: {sorted(SNAP_SPECS)}")
    if spec.family == "road":
        return _road_surrogate(spec, scale_div, device)
    return _power_law_surrogate(spec, scale_div, seed, device)


def all_dataset_names() -> list[str]:
    return list(SNAP_SPECS)
