#!/usr/bin/env python3
"""Count how often torch.profiler loses windows of device events, and
check the profiler-free launch count that ``chip_smoke.py`` relies on.

    python3 tools/profiler_probe.py [--rounds 15] [--launches 1000000]

On one card, at the retrieval server's two EmbeddingBag shapes
(``item_tags``: 2^20 bags of 8 ids over a 131,072 x 256 table;
``user_history``: 512 bags of 32 ids over a 1,048,576 x 256 table; ids and
weights from a seed), for the port's kernel and ``F.embedding_bag``:

- the device work of one call, captured in a CUDA graph and counted by node
  type (``chip_smoke.launches_per_call``);
- ``--rounds`` profiled windows of 20 calls each, three ways: the
  profiler's ``key_averages()``, its raw trace, and a trace of the device
  activity alone; for each, the windows that held no device event at all
  and the fewest events a window held (20 when nothing was lost);
- the same again after one trace of ``--launches`` tiny launches, as the
  graph phases of ``chip_smoke.py`` make before the retrieval phase.

Prints the card's name and power limit first and one JSON line at the end.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch
from torch.nn import functional as F

ROOT = Path(__file__).resolve().parents[1]
CALLS = 20


def window_events(fn, activities) -> tuple[int, int]:
    """Device events in one profiled window of CALLS calls: (raw trace,
    key_averages), the second 0 where only the device was traced."""
    from torch.autograd import DeviceType
    from torch.profiler import profile

    with profile(activities=activities) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    raw = sum(1 for e in prof.profiler.kineto_results.events() if e.device_type() == DeviceType.CUDA)
    if len(activities) == 1:
        return raw, 0
    averaged = sum(e.count for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and not e.is_user_annotation
                   and e.self_device_time_total > 0)
    return raw, averaged


def survey(fns: dict, rounds: int) -> dict:
    from torch.profiler import ProfilerActivity

    both, device = [ProfilerActivity.CPU, ProfilerActivity.CUDA], [ProfilerActivity.CUDA]
    out = {}
    for name, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        seen = {"key_averages": [], "raw": [], "device_only": []}
        for _ in range(rounds):
            raw, averaged = window_events(fn, both)
            seen["raw"].append(raw)
            seen["key_averages"].append(averaged)
            seen["device_only"].append(window_events(fn, device)[0])
        out[name] = {way: {"windows_lost": sum(n == 0 for n in ns), "fewest_events": min(ns)}
                     for way, ns in seen.items()}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=15)
    ap.add_argument("--launches", type=int, default=1_000_000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profiler_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.embedding_bag import embedding_bag_cuda

    print(cs.nvidia_smi(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    _build.build("embedding_bag")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    fns = {}
    for field, rows, bags, hot in (("item_tags", 131_072, 1_048_576, 8), ("user_history", 1_048_576, 512, 32)):
        table = torch.randn(rows, 256, device=dev, generator=gen)
        ids = torch.randint(0, rows, (bags * hot,), device=dev, generator=gen, dtype=torch.int32)
        w = torch.rand(bags * hot, device=dev, generator=gen)
        segs = torch.arange(bags, dtype=torch.int32, device=dev).repeat_interleave(hot)
        offsets = torch.arange(0, ids.numel(), hot, dtype=torch.int32, device=dev)
        fns[f"{field}_kernel"] = lambda t=table, i=ids, s=segs, w=w, b=bags: embedding_bag_cuda(t, i, s, w, b)
        fns[f"{field}_library"] = lambda t=table, i=ids, o=offsets, w=w: F.embedding_bag(
            i, t, o, mode="sum", per_sample_weights=w)
    graph_counts = {name: cs.launches_per_call(fn) for name, fn in fns.items()}
    # a call that waits on the host cannot be captured: None, and the card stays usable
    graph_counts["nonzero (host sync)"] = cs.launches_per_call(lambda: torch.nonzero(torch.ones(5, device=dev)))
    graph_counts["zeros then add_"] = cs.launches_per_call(lambda: torch.zeros(5, device=dev).add_(1))
    before = survey(fns, args.rounds)
    x = torch.zeros(16, device=dev)

    def many():
        for _ in range(args.launches):
            x.add_(1)

    by_name, wall = cs.device_time_from_trace(many)
    after = survey(fns, args.rounds)
    print(json.dumps({"profiler_probe": {
        "calls_a_window": CALLS, "rounds": args.rounds, "graph_counts": graph_counts,
        "before_big_trace": before,
        "big_trace": {"launches": args.launches, "device_ms": sum(by_name.values()), "wall_s": wall},
        "after_big_trace": after, "seconds": time.perf_counter() - t0,
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
