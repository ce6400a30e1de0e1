"""Reduction of one profiled block of rounds to device busy time, per-kernel
time, idle gaps by host span, and the device operations that took longest.

The profiler traces the card's activity alone (no host operators, so the
host path runs at its own speed). Its clock is tied to the host's by a
marker: the first device operation of the block is launched right after a
synchronize at a known host time. Host spans come from the harness's own
wrappers around the backend's ``prepare`` and ``execute`` and around each
round.
"""
from __future__ import annotations

import bisect
import dataclasses

# the port's kernels, by the device function names in src/repro_torch/csrc
KERNELS = {
    "spmv": ("spmv_blocks_kernel",),
    "degree_count": ("degree_count_runs_kernel", "degree_count_private_kernel"),
}


@dataclasses.dataclass
class DeviceBlock:
    """What one profiled block of whole rounds showed."""

    events: int                       # device operations seen
    kernel_events: dict[str, int]     # launches of each port kernel seen
    kernel_s: dict[str, float]        # each port kernel's summed device time
    busy_s: float                     # union of device operations inside the rounds
    window_s: float                   # wall of the rounds, summed
    top_ops: list                     # [[name, seconds]], longest total first
    gaps: list                        # [[host span, seconds, host ns at the gap]], longest first
    idle_by_span: dict[str, float]    # idle seconds by host span


def short_name(name: str, width: int = 80) -> str:
    for noise in ("void ", "at::native::", "(anonymous namespace)::"):
        name = name.replace(noise, "")
    return name.split("(")[0].split("<")[0][:width]


def device_events(prof) -> list[tuple[int, int, str]]:
    """(start ns, end ns, name) of every device operation in the profile,
    read from the raw trace without building the profiler's event tree."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
            continue
        out.append((int(e.start_ns()), int(e.end_ns()), e.name()))
    return out


def _merge(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    merged: list[list[int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def reduce_block(events, marker_host_ns: int, rounds: list[tuple[int, int]],
                 spans: list[tuple[int, int, str]]) -> DeviceBlock:
    """``events`` of a block whose first device operation was launched at
    host time ``marker_host_ns``; ``rounds`` the host (start, end) of each
    round in it; ``spans`` the host (start, end, name) of the backend calls
    in it, in order."""
    kernel_events = {k: 0 for k in KERNELS}
    kernel_s = {k: 0.0 for k in KERNELS}
    for a, b, name in events:
        for k, names in KERNELS.items():
            if any(n in name for n in names):
                kernel_events[k] += 1
                kernel_s[k] += (b - a) / 1e9
    if not events:
        return DeviceBlock(0, kernel_events, kernel_s, 0.0, 0.0, [], [], {})
    offset = min(a for a, _, _ in events) - marker_host_ns  # device ns - host ns
    # only the rounds count: the check between them is the benchmark's, not the program's
    wins = [(r0 + offset, r1 + offset) for r0, r1 in rounds]
    clipped = [(max(a, w0), min(b, w1), name) for a, b, name in events for w0, w1 in wins if b > w0 and a < w1]
    by_name: dict[str, float] = {}
    for a, b, name in clipped:
        key = short_name(name)
        by_name[key] = by_name.get(key, 0.0) + (b - a) / 1e9
    busy = _merge([(a, b) for a, b, _ in clipped])
    busy_ns = sum(b - a for a, b in busy)
    # idle stretches inside each round, each named by the host span its
    # middle fell in
    starts = [s for s, _, _ in spans]
    gaps = []
    idle_by_span: dict[str, float] = {}
    for w0, w1 in wins:
        inner = [ab for ab in busy if ab[0] < w1 and ab[1] > w0]
        cuts = [w0] + [x for ab in inner for x in ab] + [w1]
        for a, b in zip(cuts[0::2], cuts[1::2]):
            if b <= a:
                continue
            mid = (a + b) // 2 - offset
            i = bisect.bisect_right(starts, mid) - 1
            where = spans[i][2] if i >= 0 and spans[i][0] <= mid < spans[i][1] else "engine"
            gaps.append([where, (b - a) / 1e9, mid])
            idle_by_span[where] = idle_by_span.get(where, 0.0) + (b - a) / 1e9
    gaps.sort(key=lambda g: -g[1])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return DeviceBlock(
        events=len(events), kernel_events=kernel_events, kernel_s=kernel_s,
        busy_s=busy_ns / 1e9, window_s=sum(r1 - r0 for r0, r1 in rounds) / 1e9,
        top_ops=[[n, s] for n, s in top], gaps=gaps[:10], idle_by_span=idle_by_span,
    )
