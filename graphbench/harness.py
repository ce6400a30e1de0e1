"""One run of one cell: set-up, the measured window of rounds, the check
against the plain reference, and the result line.

A round is one ``MultiQueryEngine.run_sessions`` call of the cell's
sessions, one query each, all submitted at once; rounds run back to back
(a closed loop) until the window's seconds have passed, and the round
running then completes and counts. One ``CudaBackend`` serves every round,
as a server keeps a loaded graph's device state. A query's latency runs
from its round's start to the first engine call after its last step that
reports it done (the harness's executor subclasses stamp it).

The plain reference works out every distinct query's answer once, after
set-up and before the window, and is freed before the window starts; each
round's answers are compared with it as soon as the round ends, and only
the worst reading of each compared number is kept. The window's time is
the rounds' own: the comparisons between rounds are not the program's
work.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Any, Callable

import torch

from graphbench import devtrace as tr

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
TRACE_ROUNDS = 2      # whole rounds read for the host metrics, then profiled for the device ones
PROFILE_TRIES = 3     # profiled blocks before the device metrics are given up as lost
PEAK_BYTES_PER_S = 3.35e12  # published HBM peak of the H100 SXM (NVIDIA data sheet)


# --------------------------------------------------------------------- lookup
def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(root: Path, folder: str, name: str):
    """``graphbench/<folder>/<name>.py`` of the checkout at ``root``."""
    path = root / "graphbench" / folder / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {folder[:-1]} named {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(f"graphbench_{folder}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    workload: dict
    config: dict
    traffic: dict
    end_to_end: list[dict]   # the BENCHMARK.json metrics this cell reports
    per_layer: list[dict]


def find_cell(root: Path, name: str) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: {sorted(by_name)}")
    w = by_name[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = load_json(root / conf["file"])
    traffic = load_json(root / "graphbench" / "traffic" / f"{w['traffic']}.json")

    def mine(metrics: list[dict]) -> list[dict]:
        return [m for m in metrics if name in m.get("workloads", [name])]

    return Cell(w, config, traffic, mine(bench["end_to_end"]), mine(bench["per_layer"]))


def forbidden_modules() -> list[str]:
    """Top-level names of loaded modules that this process must not hold,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def process_start_epoch() -> float:
    """Wall time (epoch s) at which this process started, from /proc."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as f:
        btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
    return btime + ticks / os.sysconf("SC_CLK_TCK")


def host_reading() -> tuple[float, int, int, int]:
    """This process's CPU seconds, and all cores' busy, stolen and total
    jiffies (``/proc/stat``), now: what the host did beside the run, read
    around the window."""
    with open("/proc/stat") as f:
        cpu = [int(x) for x in f.readline().split()[1:9]]
    t = os.times()
    return t.user + t.system, sum(cpu[:3]) + sum(cpu[5:7]), cpu[7], sum(cpu)


def card_line() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,clocks.sm,clocks.max.sm,power.limit,power.draw",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


# ----------------------------------------------------------- instrumentation
def stamping(cls):
    """A subclass of a port executor that changes no behaviour and records
    the wall time of the first call of ``finished()`` that returns true, or
    of ``frontier()`` that reports an empty frontier."""

    class Stamped(cls):
        stamp_ns = None

        def finished(self):
            done = super().finished()
            if done and self.stamp_ns is None:
                self.stamp_ns = time.perf_counter_ns()
            return done

        def frontier(self):
            f = super().frontier()
            if f[0] <= 0 and self.stamp_ns is None:
                self.stamp_ns = time.perf_counter_ns()
            return f

    Stamped.__name__ = Stamped.__qualname__ = f"Stamped{cls.__name__}"
    return Stamped


def timed_backend(core):
    """The port's ``CudaBackend`` with its ``prepare`` and ``execute`` timed
    on the host; nothing else changes. ``spans`` (a list, or None) collects
    each call's (start, end, name)."""

    class TimedCudaBackend(core.CudaBackend):
        def __init__(self):
            super().__init__()
            self.prepare_ns = 0
            self.execute_ns = 0
            self.execute_calls = 0
            self.spans: list | None = None

        def prepare(self, executor, prep, *shard):
            t0 = time.perf_counter_ns()
            plan = super().prepare(executor, prep, *shard)
            t1 = time.perf_counter_ns()
            self.prepare_ns += t1 - t0
            if self.spans is not None:
                self.spans.append((t0, t1, "backend.prepare"))
            return plan

        def execute(self, plan, step, modeled_ns=0.0):
            t0 = time.perf_counter_ns()
            ns = super().execute(plan, step, modeled_ns=modeled_ns)
            t1 = time.perf_counter_ns()
            self.execute_ns += t1 - t0
            self.execute_calls += 1
            if self.spans is not None:
                self.spans.append((t0, t1, "backend.execute"))
            return ns

    return TimedCudaBackend()


# ------------------------------------------------------------------- the run
@dataclasses.dataclass
class Query:
    round: int
    group: int
    inst: Any
    latency_s: float
    answered: bool
    stamped: bool


@dataclasses.dataclass
class RunData:
    """What the metric readers (``metrics/<name>.py``) read."""

    cell: Cell
    setup_s: float = 0.0
    graph_build_s: float = 0.0
    window_s: float = 0.0
    queries: list[Query] = dataclasses.field(default_factory=list)
    work_edges: float = 0.0
    host: dict | None = None          # traced run: backend totals over the host rounds
    block: tr.DeviceBlock | None = None  # traced run: the profiled block that saw every launch
    needed_bytes: dict | None = None  # traced run: bytes the profiled rounds' queries need, by kernel
    peak_bytes_per_s: float = PEAK_BYTES_PER_S

    @property
    def latencies_s(self) -> list[float]:
        return [q.latency_s for q in self.queries]


def session_plan(traffic: dict) -> list[tuple[int, int]]:
    """(group, index within the group) of each session of a round."""
    return [(g, k) for g, group in enumerate(traffic["sessions"]) for k in range(int(group["count"]))]


def engine_config(core, settings: dict, backend):
    kw = dict(settings)
    if "fusion" in kw:
        kw["fusion"] = core.FusionConfig(**kw["fusion"])
    return core.EngineConfig(backend=backend, **kw)


class Checks:
    """The worst reading of each compared number, and its limit."""

    def __init__(self):
        self.readings: dict[str, dict] = {}

    def add(self, kind, got: dict[str, float]) -> None:
        for name, value in got.items():
            spec = kind.CHECKS[name]
            old = self.readings.get(name, {}).get("value")
            if old is not None:
                value = max(old, value) if spec["combine"] == "max" else old + value
            self.readings[name] = {"value": value, "limit": spec["limit"]}


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool,
             device: torch.device, log: Callable[[str], None], t_process: float | None = None) -> dict:
    """Run the cell once on ``device`` and return its result line (a dict
    whose last key, ``checks``, holds each compared number and its limit)."""
    t_process = time.time() if t_process is None else t_process
    root = Path(root)
    cell = find_cell(root, workload)
    cuda = device.type == "cuda"
    sys.path.insert(0, str(root / "src"))
    import repro_torch
    import repro_torch.algorithms
    from repro_torch import core
    from repro_torch.graph import build_graph
    from repro_torch.kernels._build import build
    from repro_torch.kernels.degree_count.degree_count import degree_count_cuda
    from repro_torch.kernels.spmv.spmv import spmv_rows_cuda

    run = RunData(cell=cell)
    plan = session_plan(cell.traffic)
    groups = cell.traffic["sessions"]
    kinds = [load_module(root, "queries", group["query"]["kind"]) for group in groups]
    if cuda:
        log(f"card: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
        build_s = build("spmv", "degree_count")
        log(f"kernel builds (s, 0 for a cached library): {build_s}")

    # the configuration's edge list, drawn on the device from the seed
    gen = load_module(root, "generators", cell.config["generator"])
    src, dst, v = gen.generate(cell.config["graph"], seed, device)
    src_h, dst_h = src.cpu().numpy(), dst.cpu().numpy()
    del src, dst
    edges = (src_h, dst_h, v)
    # each group's distinct queries, handed to its sessions in turn
    insts = [kind.instances(dict(group["query"], count=int(group["count"])), edges, seed)
             for kind, group in zip(kinds, groups)]

    def instance(r: int, g: int, k: int):
        return insts[g][(r * int(groups[g]["count"]) + k) % len(insts[g])]

    t0 = time.perf_counter()
    graph = build_graph(src_h, dst_h, v, name=cell.config["name"], device=device)
    if cuda:
        torch.cuda.synchronize()
    build_graph_s = time.perf_counter() - t0
    log(f"build_graph: V={graph.num_vertices} E={graph.num_edges} in {build_graph_s:.3f} s")

    backend = timed_backend(core)
    hw = getattr(core, cell.config["engine"]["hardware"])
    settings = cell.traffic.get("engine_config", {})
    pool = cell.traffic.get("pool_capacity")  # None: the hardware model's thread count
    stamped_cls: dict = {}

    def stamped(cls):
        if cls not in stamped_cls:
            stamped_cls[cls] = stamping(cls)
        return stamped_cls[cls]

    launches = lambda: spmv_rows_cuda.launches + degree_count_cuda.launches

    def one_round(r: int) -> tuple[int, int, list[Query], list]:
        """Run round ``r``; its wall (start, end), its queries, and each
        query's answer as the program left it."""
        made = []

        def make_executor(s, q):
            g, k = plan[s]
            inst = instance(r, g, k)
            ex = kinds[g].make(repro_torch, graph, inst, stamped)
            made.append((g, inst, ex))
            return ex

        t_start = time.perf_counter_ns()
        eng = core.MultiQueryEngine(hw, policy=cell.config["engine"]["policy"], pool_capacity=pool)
        eng.run_sessions(make_executor, sessions=len(plan), queries_per_session=1,
                         config=engine_config(core, settings, backend))
        if cuda:
            torch.cuda.synchronize()
        t_end = time.perf_counter_ns()
        out, answers = [], []
        for g, inst, ex in made:
            ok = ex.stamp_ns is not None
            ans = kinds[g].answer(ex)
            out.append(Query(r, g, inst, ((ex.stamp_ns if ok else t_end) - t_start) / 1e9, ans is not None, ok))
            answers.append(ans)
        return t_start, t_end, out, answers

    # warm-up: one untimed round stages the backend's tables and loads its kernels
    t0 = time.perf_counter()
    prep0 = backend.prepare_ns
    one_round(0)
    run.graph_build_s = build_graph_s + (backend.prepare_ns - prep0) / 1e9
    log(f"warm-up round: {time.perf_counter() - t0:.3f} s, of it staging {(backend.prepare_ns - prep0) / 1e9:.3f} s")
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"forbidden modules loaded after set-up: {bad}")
    run.setup_s = time.time() - t_process
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    # ------------------------- the reference, outside set-up and the window
    t0 = time.perf_counter()
    from graphbench.reference import GraphRef

    ref = GraphRef(torch.from_numpy(src_h).to(device), torch.from_numpy(dst_h).to(device), v)
    sizes = ref.sizes()
    want: dict = {}   # each distinct query's expected answer, on the host
    work: dict = {}   # and its edges, the benchmark's own count
    for kind, group_insts in zip(kinds, insts):
        for inst in group_insts:
            want[inst] = kind.expected(ref, inst).cpu()
            work[inst] = kind.work_edges(sizes, inst, want[inst])
    del ref
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    log(f"reference: {time.perf_counter() - t0:.3f} s for {len(want)} distinct queries")
    checks = Checks()

    def check(qs: list[Query], answers: list) -> None:
        """Compare a round's answers with the reference, one distinct query
        at a time, and let them go."""
        for inst in dict.fromkeys(q.inst for q in qs):
            w = want[inst].to(device)
            for q, ans in zip(qs, answers):
                if q.inst == inst and ans is not None:
                    checks.add(kinds[q.group], kinds[q.group].compare(ans, w))
            del w

    # ------------------------------------------------------------- window
    host_before = host_after = None
    tries, device_done = 0, not (trace and cuda)
    blocks = []
    rounds: list[tuple[int, int]] = []
    marker = torch.empty(1, device=device)
    r = 0
    window_ns = 0
    snapshot = lambda: (backend.prepare_ns, backend.execute_ns, backend.execute_calls, launches())
    host0, wall0 = host_reading(), time.perf_counter()
    while True:
        if trace and not device_done and r >= 1 + TRACE_ROUNDS:
            from torch.profiler import ProfilerActivity, profile

            n0 = {"spmv": spmv_rows_cuda.launches,
                  "degree_count": degree_count_cuda.launches}
            backend.spans = []
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                torch.cuda.synchronize()
                t_mark = time.perf_counter_ns()
                marker.fill_(1.0)
                torch.cuda.synchronize()
                block_rounds = []
                for _ in range(TRACE_ROUNDS):
                    a, b, qs, answers = one_round(r)
                    check(qs, answers)
                    del answers
                    run.queries += qs
                    rounds.append((a, b))
                    block_rounds.append((a, b))
                    window_ns += b - a
                    r += 1
            spans, backend.spans = backend.spans, None
            seen = {"spmv": spmv_rows_cuda.launches - n0["spmv"],
                    "degree_count": degree_count_cuda.launches - n0["degree_count"]}
            block = tr.reduce_block(tr.device_events(prof), t_mark, block_rounds, spans)
            tries += 1
            complete = block.events > 0 and block.kernel_events == seen
            log(f"profiled rounds {r - TRACE_ROUNDS}-{r - 1} (try {tries}): {block.events} device events, "
                f"kernel launches seen {block.kernel_events} of {seen}"
                f"{'' if complete else ': the profiler lost events, this block is not read'}")
            blocks.append((block, complete, r - TRACE_ROUNDS))
            device_done = complete or tries >= PROFILE_TRIES
        else:
            a, b, qs, answers = one_round(r)
            check(qs, answers)
            del answers
            run.queries += qs
            rounds.append((a, b))
            window_ns += b - a
            r += 1
        if trace and r == 1:
            host_before = snapshot()
        if trace and r == 1 + TRACE_ROUNDS:
            host_after = snapshot()
        if cuda:
            log(f"round {r - 1}: {(rounds[-1][1] - rounds[-1][0]) / 1e9:.3f} s, "
                f"allocated {torch.cuda.memory_allocated()} bytes")
        if window_ns / 1e9 >= seconds and device_done and r >= (1 + TRACE_ROUNDS) * trace:
            break
    run.window_s = window_ns / 1e9
    peak = max(setup_peak, torch.cuda.max_memory_allocated(device)) if cuda else 0
    host1, wall1 = host_reading(), time.perf_counter()
    busy, stolen, total = (host1[i] - host0[i] for i in (1, 2, 3))
    log(f"window: {len(rounds)} rounds, {len(run.queries)} queries in {run.window_s:.3f} s of rounds "
        f"({wall1 - wall0:.3f} s with the checks); this process's CPU {host1[0] - host0[0]:.3f} s; "
        f"all cores busy {100.0 * busy / max(total, 1):.2f}%, stolen {100.0 * stolen / max(total, 1):.2f}% "
        f"of their time; {os.cpu_count()} cores, load average {os.getloadavg()}")
    if trace:
        d = [x1 - x0 for x0, x1 in zip(host_before, host_after)]
        walls = sum(b - a for a, b in rounds[1 : 1 + TRACE_ROUNDS])
        run.host = {"prepare_s": d[0] / 1e9, "execute_s": d[1] / 1e9, "execute_calls": d[2],
                    "launches": d[3], "rounds_wall_s": walls / 1e9}
    del backend, graph, stamped_cls

    run.work_edges = sum(work[q.inst] for q in run.queries)
    unanswered = sum(not q.answered for q in run.queries)
    unstamped = sum(not q.stamped for q in run.queries)
    checks.readings["queries_unanswered"] = {"value": unanswered, "limit": 0}
    checks.readings["queries_unstamped"] = {"value": unstamped, "limit": 0}
    for block, complete, first in blocks:
        if complete:
            run.block = block
            need: dict[str, float] = {}
            for rr in range(first, first + TRACE_ROUNDS):
                for g, kind in enumerate(kinds):
                    items = [(q.inst, want[q.inst]) for q in run.queries if q.round == rr and q.group == g]
                    if items:
                        for k, b in kind.needed_bytes(sizes, items).items():
                            need[k] = need.get(k, 0.0) + b
            run.needed_bytes = need

    # ----------------------------------------------------------- the line
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = load_module(root, "metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct = all(c["value"] <= c["limit"] for c in checks.readings.values())
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    line: dict[str, Any] = {"correct": correct, "attempted": len(run.queries), "failed": unanswered,
                            "metrics": metrics, "device": dev}
    if trace and run.block is not None:
        b = run.block
        dev["busy_s"], dev["window_s"] = b.busy_s, b.window_s
        line["breakdown"] = {
            "device_ops": b.top_ops,
            "idle_gaps": [[f"{w} (round {_round_of(rounds, h)})", s] for w, s, h in b.gaps],
        }
        log(f"idle seconds by host span: {b.idle_by_span}")
    elif trace and blocks:
        b = max((blk for blk, _, _ in blocks), key=lambda blk: blk.events)
        dev["busy_s"], dev["window_s"] = b.busy_s, b.window_s
    line["checks"] = checks.readings
    return line


def _round_of(rounds: list[tuple[int, int]], host_ns: int) -> int:
    for i, (a, b) in enumerate(rounds):
        if host_ns < b:
            return i
    return len(rounds) - 1
