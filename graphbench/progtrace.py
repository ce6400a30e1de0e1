"""Reduction of a block of rounds traced by the program itself
(``repro_torch.core.tracing``) beside a device profile of the same rounds.

The recorder's spans are stamped with ``time.perf_counter_ns()``; its two
clock anchors, ``(perf_counter_ns, time_ns)`` pairs read back to back when
tracing started and stopped, put the profiler's epoch-nanosecond device
events near that clock, but not always on it. Every ``backend.execute``
span ends with a synchronize, so each spmv launch must lie inside one: the
offset used is the one nearest the anchors' (within 10 ms, in 10 us steps)
at which at least 99% of the launches do, or the anchors' own where none
does, as where steps are short and their spans cover most of the wall and
no offset fits that well. ``aligned_share`` is the share at the offset used,
``anchor_share`` the share at the anchors' own. A
marker, the block's first device operation launched right after a
synchronize at a known host time, gives a third offset for comparison. Each
idle stretch of the device inside a round is put down to the innermost
program span covering its middle (``outside engine.round`` where none does:
engine construction and the round's closing synchronize). Self time is a
span's duration less what its children cover.
"""
from __future__ import annotations

import bisect
import dataclasses

import numpy as np

from graphbench.devtrace import _merge

OUTSIDE = "outside engine.round"
FIT_RANGE_NS, FIT_STEP_NS, FIT_SHARE = 10_000_000, 10_000, 0.99


@dataclasses.dataclass
class ProgramBlock:
    """What one block of rounds traced by the program showed."""

    rounds_wall_s: float
    self_s: dict[str, float]          # summed self time by span name
    total_s: dict[str, float]         # summed duration by span name
    spans: dict[str, int]             # spans by name
    counters: dict[str, int]
    sched_self_pct: float             # sched.* self time over the rounds' wall
    executor_host_pct: float          # executor.* self time over the rounds' wall
    dispatch_host_ms: float | None    # backend.execute self time per backend.execute
    sync_wait_ms: float | None        # host.sync time (anywhere) per backend.execute
    host_syncs_per_step: float | None # host_syncs per backend.execute
    idle_s: float | None = None       # device idle inside the rounds (with a profile)
    idle_by_span: dict[str, float] | None = None
    gaps: list | None = None          # [[span, seconds, host ns]], longest first
    anchor_offset_ns: int | None = None    # device (epoch) ns - perf_counter ns, from the anchors
    marker_offset_ns: int | None = None    # the same, from the marker's launch
    offset_ns: int | None = None           # the same, fitted: the one used
    aligned_share: float | None = None     # spmv launches inside a backend.execute span, at offset_ns
    anchor_share: float | None = None      # the same, at anchor_offset_ns


def innermost(spans: list[list], starts: list[int], t: int) -> str:
    """Name of the innermost span covering host time ``t``. Spans are in
    start order and nest, so it is the last span started by ``t`` or one
    of its ancestors."""
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0 and spans[i][2] <= t:
        i = spans[i][3]
    return spans[i][0] if i >= 0 else OUTSIDE


def fit_offset(spans: list[list], events, anchor_ns: int) -> tuple[int, float | None, float | None]:
    """The offset nearest ``anchor_ns`` at which at least ``FIT_SHARE`` of
    the spmv launches lie inside a ``backend.execute`` span, or
    ``anchor_ns`` where there is none; the share at it, and at
    ``anchor_ns``."""
    ex = np.array(sorted((s[1], s[2]) for s in spans if s[0] == "backend.execute"), dtype=np.int64)
    k = np.array([(a, b) for a, b, n in events if "spmv_blocks_kernel" in n], dtype=np.int64)
    if not len(ex) or not len(k):
        return anchor_ns, None, None

    def share(off: int) -> float:
        i = np.searchsorted(ex[:, 0], k[:, 0] - off, side="right") - 1
        return float(((i >= 0) & (k[:, 1] - off <= ex[np.maximum(i, 0), 1])).mean())

    at_anchor = share(anchor_ns)
    for d in sorted(range(-FIT_RANGE_NS, FIT_RANGE_NS + 1, FIT_STEP_NS), key=abs):
        got = share(anchor_ns + d) if d else at_anchor
        if got >= FIT_SHARE:
            return anchor_ns + d, got, at_anchor
    return anchor_ns, at_anchor, at_anchor


def program_block(rec, rounds: list[tuple[int, int]], events=None,
                  marker_host_ns: int | None = None) -> ProgramBlock:
    """``rec`` a stopped recorder that traced the ``rounds`` (host
    ``perf_counter_ns`` start and end of each); ``events`` the (start ns,
    end ns, name) device operations a profiler saw meanwhile, on the epoch
    clock, or None; ``marker_host_ns`` the host time at which the block's
    first device operation was launched."""
    spans = rec.spans
    own = rec.self_ns()
    self_s: dict[str, float] = {}
    total_s: dict[str, float] = {}
    count: dict[str, int] = {}
    for s, o in zip(spans, own):
        self_s[s[0]] = self_s.get(s[0], 0.0) + o / 1e9
        total_s[s[0]] = total_s.get(s[0], 0.0) + (s[2] - s[1]) / 1e9
        count[s[0]] = count.get(s[0], 0) + 1
    wall = sum(b - a for a, b in rounds) / 1e9
    share = lambda prefix: 100.0 * sum(v for k, v in self_s.items() if k.startswith(prefix)) / wall
    steps = count.get("backend.execute", 0)
    per_step = lambda x: x / steps if steps else None
    block = ProgramBlock(
        rounds_wall_s=wall, self_s=self_s, total_s=total_s, spans=count, counters=dict(rec.counters),
        sched_self_pct=share("sched."), executor_host_pct=share("executor."),
        dispatch_host_ms=per_step(1e3 * self_s.get("backend.execute", 0.0)),
        sync_wait_ms=per_step(1e3 * total_s.get("host.sync", 0.0)),
        host_syncs_per_step=per_step(rec.counters.get("host_syncs", 0)),
    )
    if not events:
        return block
    block.anchor_offset_ns = round(rec.epoch_offset_ns())
    if marker_host_ns is not None:
        block.marker_offset_ns = min(a for a, _, _ in events) - marker_host_ns
    off, block.aligned_share, block.anchor_share = fit_offset(spans, events, block.anchor_offset_ns)
    block.offset_ns = off
    busy = _merge([(a - off, b - off) for a, b, _ in events])
    starts = [s[1] for s in spans]
    gaps, by_span = [], {}
    for w0, w1 in rounds:
        cuts = [w0] + [min(max(x, w0), w1) for ab in busy if ab[0] < w1 and ab[1] > w0 for x in ab] + [w1]
        for a, b in zip(cuts[0::2], cuts[1::2]):
            if b > a:
                where = innermost(spans, starts, (a + b) // 2)
                gaps.append([where, (b - a) / 1e9, (a + b) // 2])
                by_span[where] = by_span.get(where, 0.0) + (b - a) / 1e9
    gaps.sort(key=lambda g: -g[1])
    block.idle_s, block.idle_by_span, block.gaps = sum(g[1] for g in gaps), by_span, gaps[:10]
    return block
