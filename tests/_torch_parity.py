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
    """Vertex ids by descending out-degree (the benchmarks' BFS sources),
    from a JAX array or a tensor on any device."""
    if hasattr(degrees, "is_cuda"):
        degrees = degrees.cpu()
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


def plain(x):
    """``x`` as plain Python values that compare equal across packages:
    dataclasses as dicts of their fields, numpy, JAX and torch arrays as
    nested lists, numpy scalars as Python numbers, containers element by
    element. A float NaN becomes the string ``"nan"`` so that equal NaNs
    compare equal."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, (set, frozenset)):
        return sorted(plain(v) for v in x)
    if hasattr(x, "detach") and hasattr(x, "cpu"):  # a torch tensor
        return plain(x.detach().cpu().numpy())
    if hasattr(x, "__array__") and not isinstance(x, (str, bytes)):
        x = np.asarray(x)
        return plain(x.tolist()) if x.ndim else plain(x.item())
    if isinstance(x, np.generic):
        return plain(x.item())
    if isinstance(x, float) and x != x:
        return "nan"
    return x


def packages() -> dict:
    """``{"jax": (algorithms, core), "torch": (algorithms, core)}`` of the
    two packages."""
    import repro.algorithms as jalg
    import repro.core as jcore
    import repro_torch.algorithms as talg
    import repro_torch.core as tcore

    return {"jax": (jalg, jcore), "torch": (talg, tcore)}


def report_view(report) -> dict:
    """Every field of an ``EngineReport`` as plain values, but the measured
    makespan (a host clock)."""
    view = plain(report)
    view.pop("makespan_measured_ns")
    return view


def both(scenario, view=plain):
    """Run ``scenario(alg, core, pkg)`` once with each package's modules;
    ``view`` of the two results must be equal. Returns the port's result
    and the reference's."""
    out = {pkg: scenario(alg, core, pkg) for pkg, (alg, core) in packages().items()}
    assert view(out["torch"]) == view(out["jax"])
    return out["torch"], out["jax"]
