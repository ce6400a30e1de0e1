#!/usr/bin/env python3
"""Trace a graph benchmark cell's rounds with the program's own tracer
(``repro_torch.core.tracing``) on the card.

    python3 tools/trace_rounds.py --workload grid-pr16 --seeds 11 12 13 [--ab 6] [--raw] [--out DIR]

For each seed, one cell of ``BENCHMARK.json`` set up as
``graphbench/run.py`` sets it up (the edge list drawn on the card, one
``CudaBackend`` wrapped by the harness's timer, stamped executors), with
the tracer on around ``build_graph``; then a warm-up round and:

- rounds 1-2 untraced: the harness's host readings (``engine_host_pct``,
  ``backend_step_ms``, ``launches_per_step``);
- rounds 3-4 under the device profiler alone, reduced by ``devtrace`` as
  the benchmark's traced run reduces them (idle time named by the
  harness's wrappers);
- rounds 5-6, the program block: the tracer on beside the device profiler,
  reduced by ``progtrace`` (idle time named by the program's spans, device
  events carried onto the host clock by an offset fitted near the tracer's
  anchors, the anchors' and the marker's offsets beside it, and a second
  marker's, launched after the first has run);

each profiled block tried again, up to three times, where the profiler saw
fewer launches than the kernels counted. Then ``--ab`` rounds without the
profiler, the tracer on and off in turns (on first on odd seeds), for the
tracer's own cost, and the program's host readings of those traced rounds
(no profiler); the answers of every traced round are compared bit for bit
with the same query's answer in an untraced round. The program block's
counters include ``bfs.level_sweeps`` and ``bfs.ranges_served``, printed
with their engage share (ranges served over ranges). Full garbage
collections are timed throughout. Last, the cost of one instrumented site
with tracing off and on, timed in a loop, times the sites a round visits.

Prints one JSON line per seed (and writes them to
``trace_rounds.jsonl`` in ``--out``, ``build/trace_rounds`` by default).
Needs one CUDA device.
"""
from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
PROFILE_TRIES = 3


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def site_ns(tracing, on: bool, n: int = 500_000) -> float:
    """Nanoseconds one ``with tracing.span(...)`` costs, tracing on or off."""
    def empty():
        for _ in range(n):
            pass

    def sites():
        for _ in range(n):
            with tracing.span("x"):
                pass

    t0 = time.perf_counter_ns()
    empty()
    t1 = time.perf_counter_ns()
    if on:
        tracing.start()
    sites()
    t2 = time.perf_counter_ns()
    tracing.stop()
    return ((t2 - t1) - (t1 - t0)) / n


full_gc: list[float] = []  # each full (generation 2) garbage collection's ms, in order


def _gc_watch(phase: str, info: dict) -> None:
    if info["generation"] == 2:
        if phase == "start":
            _gc_watch.t0 = time.perf_counter_ns()
        else:
            full_gc.append((time.perf_counter_ns() - _gc_watch.t0) / 1e6)


def run_seed(workload: str, seed: int, ab: int, device: torch.device, raw: Path | None = None) -> dict:
    """One seed of the cell; ``raw``, a folder to write the program block's spans and device events to."""
    from graphbench import devtrace, harness, progtrace
    from repro_torch import core
    import repro_torch
    import repro_torch.algorithms  # noqa: F401  (the query kinds' executors)
    from repro_torch.core import tracing
    from repro_torch.graph import build_graph
    from repro_torch.kernels.degree_count.degree_count import degree_count_cuda
    from repro_torch.kernels.spmv.spmv import spmv_rows_cuda
    from torch.profiler import ProfilerActivity, profile

    cell = harness.find_cell(ROOT, workload)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    plan = harness.session_plan(cell.traffic)
    groups = cell.traffic["sessions"]
    kinds = [harness.load_module(ROOT, "queries", g["query"]["kind"]) for g in groups]
    gen = harness.load_module(ROOT, "generators", cell.config["generator"])
    src, dst, v = gen.generate(cell.config["graph"], seed, device)
    src_h, dst_h = src.cpu().numpy(), dst.cpu().numpy()
    del src, dst
    insts = [kind.instances(dict(g["query"], count=int(g["count"])), (src_h, dst_h, v), seed)
             for kind, g in zip(kinds, groups)]

    setup = tracing.start()
    t0 = time.perf_counter()
    graph = build_graph(src_h, dst_h, v, name=cell.config["name"], device=device)
    sync()
    build_graph_s = time.perf_counter() - t0
    tracing.stop()
    setup_s = {n: sum(s[2] - s[1] for s in setup.spans if s[0] == n) / 1e9
               for n in ("graph.build", "graph.csr", "graph.upload")}

    backend = harness.timed_backend(core)
    hw = getattr(core, cell.config["engine"]["hardware"])
    settings = cell.traffic.get("engine_config", {})
    pool = cell.traffic.get("pool_capacity")
    stamped_cls: dict = {}

    def stamped(cls):
        if cls not in stamped_cls:
            stamped_cls[cls] = harness.stamping(cls)
        return stamped_cls[cls]

    kept: dict = {}      # an untraced round's answer of each query, on the host
    compared = [0, 0]    # traced answers compared, and equal
    r = 0

    def one_round(traced: bool) -> tuple[int, int]:
        """Round ``r`` as the harness runs it: its host (start, end)."""
        nonlocal r
        made = []

        def make_executor(s, q):
            g, k = plan[s]
            inst = insts[g][(r * int(groups[g]["count"]) + k) % len(insts[g])]
            ex = kinds[g].make(repro_torch, graph, inst, stamped)
            made.append((g, inst, ex))
            return ex

        a = time.perf_counter_ns()
        eng = core.MultiQueryEngine(hw, policy=cell.config["engine"]["policy"], pool_capacity=pool)
        eng.run_sessions(make_executor, sessions=len(plan), queries_per_session=1,
                         config=harness.engine_config(core, settings, backend))
        sync()
        b = time.perf_counter_ns()
        for g, inst, ex in made:
            ans = kinds[g].answer(ex).cpu()
            if not traced:
                kept.setdefault(inst, ans)
            elif inst in kept:
                compared[0] += 1
                compared[1] += int(torch.equal(ans, kept[inst]))
        r += 1
        return a, b

    launches = lambda: {"spmv": spmv_rows_cuda.launches, "degree_count": degree_count_cuda.launches}
    marker = torch.empty(1, device=device)
    # the device's activity alone; the host's where there is no card (a rehearsal)
    activity = ProfilerActivity.CUDA if device.type == "cuda" else ProfilerActivity.CPU

    def profiled_block(program: bool):
        """Two rounds under the device profiler, with the tracer on or not;
        retried while the profiler loses launches."""
        for attempt in range(1, PROFILE_TRIES + 1):
            n0 = launches()
            backend.spans = []
            sync()
            with profile(activities=[activity]) as prof:
                sync()
                rec = tracing.start() if program else None
                t_mark = time.perf_counter_ns()
                marker.fill_(1.0)
                sync()
                t_mark2 = time.perf_counter_ns()  # a second marker, past any first-launch delay
                marker.fill_(2.0)
                sync()
                rounds = [one_round(program) for _ in range(2)]
                if program:
                    tracing.stop()
            spans, backend.spans = backend.spans, None
            seen = {k: n - n0[k] for k, n in launches().items()}
            events = devtrace.device_events(prof)
            dev = devtrace.reduce_block(events, t_mark, rounds, spans)
            if dev.events > 0 and dev.kernel_events == seen:
                return dev, rec, events, (t_mark, t_mark2), rounds, attempt
            log(f"seed {seed}: profiler saw {dev.kernel_events} of {seen} launches (try {attempt})")
        return dev, rec, events, (t_mark, t_mark2), rounds, PROFILE_TRIES

    one_round(False)                                        # warm-up
    snap = lambda: (backend.prepare_ns, backend.execute_ns, backend.execute_calls, sum(launches().values()))
    h0 = snap()
    host_rounds = [one_round(False) for _ in range(2)]      # rounds 1-2
    h = [x1 - x0 for x0, x1 in zip(h0, snap())]
    host_wall = sum(b - a for a, b in host_rounds)
    dev, _, _, _, dev_rounds, dev_tries = profiled_block(False)       # rounds 3-4
    n_gc = len(full_gc)
    pdev, rec, events, (t_mark, t_mark2), prog_rounds, prog_tries = profiled_block(True)  # rounds 5-6
    gc_program = full_gc[n_gc:]
    prog = progtrace.program_block(rec, prog_rounds, events, t_mark)
    firsts = sorted(a for a, _, _ in events)[:2]
    marker2_ns = firsts[1] - t_mark2 if len(firsts) == 2 else None
    if raw:
        import gzip

        with gzip.open(raw / f"trace_raw_{workload}_{seed}.json.gz", "wt") as f:
            json.dump({"spans": rec.spans, "anchors": rec.anchors, "markers": [t_mark, t_mark2], "rounds": prog_rounds,
                       "events": [(a, b, devtrace.short_name(n, 40)) for a, b, n in events]}, f)
    walls = {True: [], False: []}
    host_only = []  # the program's host readings of each traced round without the profiler
    gc_full = {True: [], False: []}
    for i in range(ab):
        on = (i + seed) % 2 == 1
        if on:
            tracing.start()
        n_gc = len(full_gc)
        a, b = one_round(on)
        if on:
            host_only.append(progtrace.program_block(tracing.stop(), [(a, b)]))
        walls[on].append((b - a) / 1e9)
        gc_full[on] += full_gc[n_gc:]
    sites = len(rec.spans) / len(prog_rounds)
    off_ns, on_ns = site_ns(tracing, False), site_ns(tracing, True)
    round_s = sum(b - a for a, b in prog_rounds) / 1e9 / len(prog_rounds)
    del backend, graph, stamped_cls
    mean = lambda xs: sum(xs) / len(xs) if xs else None
    # BFS levels swept once for the whole frontier, and ranges answered from their level's sweep
    sweeps, served = (prog.counters.get(k, 0) for k in ("bfs.level_sweeps", "bfs.ranges_served"))
    host_keys = ("sched_self_pct", "executor_host_pct", "dispatch_host_ms", "sync_wait_ms", "host_syncs_per_step")
    return {
        "workload": workload, "seed": seed,
        "build_graph_s": build_graph_s, "setup_spans_s": setup_s, "csr_build_s": setup_s["graph.csr"],
        "host_rounds_s": [(b - a) / 1e9 for a, b in host_rounds],
        "engine_host_pct": 100.0 * (1 - (h[0] + h[1]) / host_wall),
        "backend_step_ms": 1e-6 * h[1] / h[2], "launches_per_step": h[3] / h[2],
        "device_rounds_s": [(b - a) / 1e9 for a, b in dev_rounds], "device_tries": dev_tries,
        "device_idle_pct": 100.0 * (1.0 - dev.busy_s / dev.window_s) if dev.window_s else None,
        "device_idle_by_harness_span": dev.idle_by_span,
        "program_rounds_s": [(b - a) / 1e9 for a, b in prog_rounds], "program_tries": prog_tries,
        "program_device_idle_pct": 100.0 * (1.0 - pdev.busy_s / pdev.window_s) if pdev.window_s else None,
        "sched_self_pct": prog.sched_self_pct, "executor_host_pct": prog.executor_host_pct,
        "dispatch_host_ms": prog.dispatch_host_ms, "sync_wait_ms": prog.sync_wait_ms,
        "host_syncs_per_step": prog.host_syncs_per_step,
        "idle_s": prog.idle_s, "idle_by_span": prog.idle_by_span, "gaps": prog.gaps,
        "self_s": prog.self_s, "total_s": prog.total_s, "spans": prog.spans, "counters": prog.counters,
        "bfs_level_sweeps": sweeps, "bfs_ranges_served": served,
        "bfs_engage_share": served / (served + sweeps) if served + sweeps else None,
        "anchor_offset_ns": prog.anchor_offset_ns, "marker_offset_ns": prog.marker_offset_ns,
        "offset_ns": prog.offset_ns, "aligned_share": prog.aligned_share, "anchor_share": prog.anchor_share,
        "anchor_drift_us": ((rec.anchors[1][1] - rec.anchors[1][0]) - (rec.anchors[0][1] - rec.anchors[0][0])) / 1e3,
        "marker_minus_anchor_us": (prog.marker_offset_ns - prog.anchor_offset_ns) / 1e3 if events else None,
        "marker2_minus_anchor_us": (marker2_ns - prog.anchor_offset_ns) / 1e3 if marker2_ns is not None else None,
        "fit_minus_anchor_us": (prog.offset_ns - prog.anchor_offset_ns) / 1e3 if events else None,
        "ab_on_s": walls[True], "ab_off_s": walls[False],
        "ab_cost_pct": 100.0 * (mean(walls[True]) / mean(walls[False]) - 1) if walls[True] and walls[False] else None,
        "answers_compared": compared[0], "answers_equal": compared[1],
        "off_site_ns": off_ns, "on_site_ns": on_ns, "sites_per_round": sites,
        "off_cost_pct": 100.0 * sites * off_ns / 1e9 / round_s,
        "on_cost_pct": 100.0 * sites * on_ns / 1e9 / round_s,
        "host_only": {k: mean([getattr(blk, k) for blk in host_only]) for k in host_keys},
        "gc_full_ms": {"program": gc_program, "ab_on": gc_full[True], "ab_off": gc_full[False]},
    }


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--ab", type=int, default=6)
    p.add_argument("--raw", action="store_true", help="also write each seed's spans and device events")
    p.add_argument("--out", type=Path, default=ROOT / "build" / "trace_rounds", help="folder for the results")
    args = p.parse_args()
    if not torch.cuda.is_available():
        log("no CUDA device")
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    log(f"card: {card}; torch {torch.__version__}")
    from repro_torch.kernels._build import build

    build("spmv", "degree_count")
    gc.callbacks.append(_gc_watch)
    args.out.mkdir(parents=True, exist_ok=True)
    out = args.out / "trace_rounds.jsonl"
    for seed in args.seeds:
        raw = args.out if args.raw else None
        line = dict(run_seed(args.workload, seed, args.ab, torch.device("cuda", 0), raw), card=card)
        with open(out, "a") as f:
            f.write(json.dumps(line) + "\n")
        print(json.dumps({k: v for k, v in line.items() if k not in ("gaps", "self_s", "total_s")}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
