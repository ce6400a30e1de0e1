"""Activation-sharding context (the reference's ``repro.sharding.context``).

The reference's models call ``constrain(x, logical_axes)`` at their hot
intermediates; under an active mesh context the call becomes a sharding
constraint. One device has nothing to constrain: here ``constrain`` returns
its tensor unchanged, and under an active context it first computes the
spec, so an axes/shape rank mismatch fails as the reference's does. The
port's models do not call it.

``unrolled_scans``/``scan_unroll`` are the reference's switch for the
dry-run's trip-1/trip-2 analysis (XLA counts a loop body once). The port's
layers and microbatches are Python loops, always unrolled; the switch is
kept so the dry-run runs its analysis as the reference does.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Any

from .rules import default_rules, spec_for

_ACTIVE: contextvars.ContextVar[tuple[Any, dict] | None] = contextvars.ContextVar(
    "repro_torch_sharding_ctx", default=None
)


@contextlib.contextmanager
def activation_sharding(mesh, rules: dict | None = None):
    token = _ACTIVE.set((mesh, rules or default_rules(mesh)))
    try:
        yield
    finally:
        _ACTIVE.reset(token)


def active() -> tuple[Any, dict] | None:
    return _ACTIVE.get()


def constrain(x: Any, axes: tuple | None):
    ctx = _ACTIVE.get()
    if ctx is None or axes is None:
        return x
    mesh, rules = ctx
    spec_for(tuple(axes), tuple(x.shape), mesh, rules)
    return x


_UNROLL: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "repro_torch_scan_unroll", default=False
)


@contextlib.contextmanager
def unrolled_scans():
    token = _UNROLL.set(True)
    try:
        yield
    finally:
        _UNROLL.reset(token)


def scan_unroll() -> bool:
    return _UNROLL.get()
