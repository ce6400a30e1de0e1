"""Mesh descriptions (the reference's ``repro.launch.mesh``). A FUNCTION,
not a module-level constant: importing this module touches no device state.

:class:`Mesh` is what the sharding plan reads: ``axis_names`` and
``shape`` (name → size, in axis order), with the devices it covers where
there are any. The production layouts are plans only, with no devices,
as the reference's dry-run plans them on forced host devices."""
from __future__ import annotations

import dataclasses
import math

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: tuple[str, ...]
    shape: dict[str, int]
    devices: tuple = ()

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


def _mesh(shape: tuple[int, ...], axes: tuple[str, ...], devices: tuple = ()) -> Mesh:
    return Mesh(axis_names=axes, shape=dict(zip(axes, shape)), devices=devices)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Production mesh: one pod 16×16 (data, model), or 2 pods 2×16×16
    (pod, data, model)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(shape, axes)


def make_local_mesh(model: int = 1, *, device=None) -> Mesh:
    """Mesh over the local CUDA devices ((1, 1) on one card), or over the
    one ``device`` named (the CPU tests)."""
    if device is not None:
        devices = (torch.device(device),)
    else:
        devices = tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))
        if not devices:
            raise RuntimeError("no CUDA device is available; pass device='cpu' to plan on the CPU")
    return _mesh((len(devices) // model, model), ("data", "model"), devices)
