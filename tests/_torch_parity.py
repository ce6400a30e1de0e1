"""Shared helpers for the PyTorch port's parity tests: carry a JAX-package
graph across to the port, and flatten engine results of either package into
plain values that compare equal across packages."""
from __future__ import annotations

import dataclasses

import numpy as np


def port_graph(jg):
    """The port's ``Graph`` on the CPU with the identical topology, built
    from a JAX-package graph through ``graph_from_arrays``."""
    from repro_torch.graph import graph_from_arrays

    return graph_from_arrays(
        np.asarray(jg.csr.indptr),
        np.asarray(jg.csr.indices),
        np.asarray(jg.csr_in.indptr),
        np.asarray(jg.csr_in.indices),
        np.asarray(jg.src),
        np.asarray(jg.dst),
        dataclasses.asdict(jg.stats),
        name=jg.name,
        surrogate=jg.surrogate,
        epoch=jg.epoch,
        device="cpu",
    )


def hubs(degrees) -> np.ndarray:
    """Vertex ids by descending out-degree (the benchmarks' BFS sources)."""
    return np.argsort(-np.asarray(degrees))


def records(report) -> list[dict]:
    """Every field of every query record, decision traces included."""
    return [dataclasses.asdict(r) for r in report.records]


def report_numbers(report) -> tuple:
    return (
        report.makespan_modeled_ns,
        report.throughput_modeled(),
        report.total_stolen,
        report.total_fused,
        len(report.fusion_events),
    )
