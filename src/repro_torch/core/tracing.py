"""In-process spans and counters for the graph engine's host path.

Tracing is off unless a caller turns it on in code::

    rec = tracing.start()
    ... engine.run_sessions(...) ...
    tracing.stop()          # rec now holds every span and counter

Off, each instrumented site costs one global check: ``span()`` hands back
one shared no-op context manager, and ``count()`` and ``host_read()``'s
counting return at once; nothing is allocated per call. On, each span is a
row ``(name, start_ns, end_ns, parent, key)`` of the recorder, kept a
column a field: ``start_ns``/``end_ns`` from ``time.perf_counter_ns()``,
``parent`` the index of the span open around it (``-1`` for a root: one
host thread runs the engine loop, so a stack gives the parents), ``key``
the ``(session, query)`` the span serves, inherited from the parent when
the site gives none.

``host_read`` is the one way the graph executors and ``CudaBackend`` read
the device from the host (``torch.cuda.synchronize``, ``float``/``int`` of
a device tensor, ``.cpu()``): each such read of a CUDA device counts
``host_syncs`` and opens a ``host.sync`` span, and returns what the bare
read returns.

The recorder reads two clock anchors, a ``(perf_counter_ns, time_ns)`` pair
taken back to back at ``start()`` and again at ``stop()``, so spans can be
laid on an epoch-stamped trace (the device profiler's). It also snapshots
the graph kernels' own ``launches`` counters at both ends and keeps the
difference under ``launches.<kernel>`` beside ``host_syncs``: the kernels'
attributes stay where their readers read them.
"""
from __future__ import annotations

import time
from typing import Any, Callable

import torch

__all__ = ["Recorder", "count", "host_read", "span", "start", "stop"]


class Recorder:
    """What one traced stretch recorded, handed over by ``stop()``."""

    def __init__(self) -> None:
        # one list a field: a span adds no object the garbage collector
        # tracks, so tracing does not bring on full collections mid-round
        self.names: list[str] = []
        self.starts: list[int] = []
        self.ends: list[int] = []
        self.parents: list[int] = []
        self.keys: list[Any] = []
        self.counters: dict[str, int] = {}
        self.anchors: list[tuple[int, int]] = []  # (perf_counter_ns, time_ns) at start, at stop
        self._stack: list[int] = []
        self._launches0 = _launches()

    @property
    def spans(self) -> list[tuple]:
        """Every span as ``(name, start_ns, end_ns, parent, key)``."""
        return list(zip(self.names, self.starts, self.ends, self.parents, self.keys))

    def epoch_offset_ns(self) -> float:
        """``time_ns - perf_counter_ns``, the mean of the two anchors: add it
        to a span's stamp to put the span on the epoch clock."""
        return sum(e - p for p, e in self.anchors) / len(self.anchors)

    def self_ns(self) -> list[int]:
        """Each span's duration less what its children cover (children of
        one parent follow each other on one thread: they never overlap)."""
        own = [b - a for a, b in zip(self.starts, self.ends)]
        for i, parent in enumerate(self.parents):
            if parent >= 0:
                own[parent] -= self.ends[i] - self.starts[i]
        return own


class _Span:
    """An open span of a recorder (made only while tracing is on)."""

    __slots__ = ("_rec", "_name", "_key", "_i")

    def __init__(self, rec: Recorder, name: str, key: Any) -> None:
        self._rec, self._name, self._key = rec, name, key

    def __enter__(self) -> "_Span":
        rec = self._rec
        parent = rec._stack[-1] if rec._stack else -1
        key = self._key
        if key is None and parent >= 0:
            key = rec.keys[parent]
        self._i = len(rec.names)
        rec.names.append(self._name)
        rec.parents.append(parent)
        rec.keys.append(key)
        rec.ends.append(0)
        rec._stack.append(self._i)
        rec.starts.append(time.perf_counter_ns())
        return self

    def __exit__(self, *exc: object) -> bool:
        rec = self._rec
        rec.ends[self._i] = time.perf_counter_ns()
        rec._stack.pop()
        return False


class _Off:
    """The shared no-op span of tracing off."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, *exc: object) -> bool:
        return False


_OFF = _Off()
_rec: Recorder | None = None


def _launches() -> dict[str, int]:
    from ..kernels.degree_count.degree_count import degree_count_cuda
    from ..kernels.spmv.spmv import spmv_rows_cuda

    return {"spmv": spmv_rows_cuda.launches, "degree_count": degree_count_cuda.launches}


def _anchor() -> tuple[int, int]:
    return time.perf_counter_ns(), time.time_ns()


def start() -> Recorder:
    """Turn tracing on with a fresh recorder, and return it."""
    global _rec
    rec = Recorder()
    rec.anchors.append(_anchor())
    _rec = rec
    return rec


def stop() -> Recorder | None:
    """Turn tracing off; the recorder that was on (None if none was)."""
    global _rec
    rec, _rec = _rec, None
    if rec is not None:
        rec.anchors.append(_anchor())
        for name, n in _launches().items():
            rec.counters[f"launches.{name}"] = n - rec._launches0[name]
    return rec


def span(name: str, key: Any = None):
    """A context manager that records ``name`` around its block."""
    rec = _rec
    if rec is None:
        return _OFF
    return _Span(rec, name, key)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name``."""
    rec = _rec
    if rec is None:
        return
    rec.counters[name] = rec.counters.get(name, 0) + n


def _is_cuda(x: torch.Tensor | torch.device) -> bool:
    return x.type == "cuda" if isinstance(x, torch.device) else x.is_cuda


def _read(x: torch.Tensor | torch.device, convert: Callable | None) -> Any:
    if isinstance(x, torch.device):
        if x.type == "cuda":
            torch.cuda.synchronize(x)
        return None
    return x.cpu() if convert is None else convert(x)


def host_read(x: torch.Tensor | torch.device, convert: Callable | None = None) -> Any:
    """Read the device from the host: ``convert(x)`` of a tensor (``float``,
    ``int``), ``x.cpu()`` when ``convert`` is None, or, for a
    ``torch.device``, a synchronize of it when it is a CUDA device (None).
    A read of a CUDA device, with tracing on, counts ``host_syncs`` and
    records a ``host.sync`` span."""
    rec = _rec
    if rec is None or not _is_cuda(x):
        return _read(x, convert)
    count("host_syncs")
    with _Span(rec, "host.sync", None):
        return _read(x, convert)
