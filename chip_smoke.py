#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

It needs one CUDA device and runs at the main path's full size, RMAT scale
20; for a quick check at small sizes run ``tests/test_torch_cuda.py``.
Phases, each raising on failure:

1. environment — torch/CUDA versions, the card's name and power limit;
2. build — both CUDA kernels from ``src/repro_torch/csrc`` (nvcc, sm_90a);
3. kernels vs their plain PyTorch versions on the card, at the main path's
   shapes (RMAT scale 20, Graph500 parameters, seed 3);
4. main path — fig20's tenant mix (6 PageRank-pull, 4 BFS, 2 degree-count
   sessions) through ``MultiQueryEngine`` with the ``cuda`` backend, stealing
   and heterogeneous fusion on; every result checked against its numpy
   oracle, each kernel's launch count > 0, and the modeled throughput equal
   to the same run on the ``modeled`` backend;
5. timing — CUDA-event medians per kernel beside the plain version, one
   PyTorch library call and the card's lower bound, printed as one JSON line;
6. isolation — neither JAX nor the JAX package was imported.

The last line is ``{"ok": true, "device": {...}}``. Without a CUDA device, or
outside a checkout of the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SCALE, SEED = 20, 3  # RMAT scale 20: 1,048,576 vertices, 16,777,216 edges

# fig20's tenant mix and engine settings (benchmarks/fig20_hetero_fusion.py)
ALGOS = ("pr_pull",) * 6 + ("bfs",) * 4 + ("degree_count",) * 2
POOL, HOLD_NS, MAX_MEMBERS = 16, 5e4, 12
PR_ITERS = 5

# f32 sums of the same positive terms in another order (warp tree vs the
# plain version's atomic adds): relative error grows like sqrt(row length)
# times float32 epsilon, ~2e-5 for the longest rows of this graph
SPMV_RTOL, SPMV_ATOL = 1e-4, 1e-12
PR_RTOL, PR_ATOL = 2e-4, 1e-8  # the JAX package's PageRank tolerance

TIMED_BATCHES, TIMED_PER_BATCH = 5, 20
# published H100 peaks (NVIDIA data sheets): HBM bytes/s by part, and the
# float32/int32 CUDA-core rate for the adds these kernels do
HBM_BYTES_PER_S = {"PCIe": 2.0e12, "NVL": 3.9e12, "SXM": 3.35e12}
CUDA_CORE_OPS_PER_S = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def hbm_bytes_per_s(name: str) -> float:
    for part, rate in HBM_BYTES_PER_S.items():
        if part in name:
            return rate
    return HBM_BYTES_PER_S["SXM"]


def bound_ms(n_bytes: float, n_ops: float, bw: float) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / bw * 1e3, n_ops / CUDA_CORE_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, warmup: int = 3) -> float:
    """Per-launch device time: CUDA events around batches of back-to-back
    launches (so host overhead overlaps the device work), median over the
    batches, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(TIMED_BATCHES):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(TIMED_PER_BATCH):
            fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) / TIMED_PER_BATCH for a, b in pairs]))


def device_time_by_kernel(run) -> tuple[dict[str, float], float]:
    """Device time per kernel or copy name (ms) over one call of ``run``,
    from torch.profiler, and the call's wall time (s). Only device-side
    events count: a CPU op such as ``aten::copy_`` also carries the device
    time of what it launched, which is listed on its own as well."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name: dict[str, float] = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.is_user_annotation:
            continue
        us = e.self_device_time_total
        if us > 0:
            by_name[e.key] = by_name.get(e.key, 0.0) + us / 1e3
    return by_name, wall


def run_mix(core, alg, graph, backend: str):
    """fig20's heterofuse run: 12 sessions, one query each."""
    hubs = np.argsort(-graph.out_degrees().cpu().numpy())
    made = []

    def mk(s, q):
        kind = ALGOS[s]
        if kind == "bfs":
            ex = alg.BFSExecutor(graph, int(hubs[s % 8]))
        elif kind == "pr_pull":
            ex = alg.PageRankExecutor(graph, mode="pull", max_iters=PR_ITERS, tol=0)
        else:
            ex = alg.DegreeCountExecutor(graph)
        made.append(ex)
        return ex

    eng = core.MultiQueryEngine(core.XEON_E5_2660V4, pool_capacity=POOL, policy="scheduler")
    cfg = core.EngineConfig(
        steal=True,
        fuse=True,
        hetero_fuse=True,
        fusion=core.FusionConfig(hold_ns=HOLD_NS, max_members=MAX_MEMBERS),
        backend=backend,
    )
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = eng.run_sessions(mk, sessions=len(ALGOS), queries_per_session=1, config=cfg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if eng.pool.available != eng.pool.capacity:
        raise AssertionError("worker grants leaked")
    return rep, made, wall


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() != 1:
        print(f"chip_smoke: needs one CUDA device, sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import algorithms as alg
    from repro_torch import core
    from repro_torch.graph import rmat_graph
    from repro_torch.kernels import _build
    from repro_torch.kernels.degree_count import degree_count_cuda, degree_count_plain
    from repro_torch.kernels.spmv import (
        DST_TILE, build_tiles, spmv_rows_cuda, spmv_rows_plain, spmv_tiles,
    )

    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # 1. environment ---------------------------------------------------------
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    log(smi)
    bw = hbm_bytes_per_s(smi)

    # 2. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    secs = _build.build("spmv", "degree_count")
    log(f"build: {time.perf_counter() - t0:.2f} s wall, per source {secs} (nvcc sm_90a)")
    for name, text in _build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # 3. kernels vs plain versions at the main path's shapes ------------------
    t0 = time.perf_counter()
    g = rmat_graph(SCALE, seed=SEED, device=dev)
    V, E = g.num_vertices, g.num_edges
    log(f"graph rmat_sf{SCALE}: V={V} E={E} built in {time.perf_counter() - t0:.1f} s")
    pr = alg.PageRankExecutor(g, mode="pull", max_iters=1, tol=0)
    pr.start()
    contrib = pr.contrib
    in_src, in_dst = pr.pull_edges()
    t_in = build_tiles(in_src, in_dst, V)
    t_out = build_tiles(g.src, g.dst, V)
    T = t_in.n_tiles
    log(f"tables: {T} tiles of {DST_TILE}, long rows in/out: "
        f"{t_in.long_rows.numel()}/{t_out.long_rows.numel()}")
    # what the TPU kernel's layout (every tile padded to the fullest tile,
    # rounded up to 128 lanes; int32 source + local-target tables) would hold
    tile_edges = t_in.row_ptr[DST_TILE::DST_TILE] - t_in.row_ptr[:-1:DST_TILE]
    chunk = -(-int(tile_edges.max()) // 128) * 128
    log(f"padded TPU layout: chunk {chunk} lanes, {T * chunk / E:.2f} lanes per edge, "
        f"{2 * 4 * T * chunk / 1e9:.2f} GB per direction (ragged: {(4 * E + 8 * (T * 512 + 1)) / 1e9:.2f} GB)")
    spmv_err = 0.0

    def check_spmv(tables, c, a, b, exact: bool, what: str):
        nonlocal spmv_err
        got = spmv_tiles(tables, c, a, b).reshape(-1)
        again = spmv_tiles(tables, c, a, b).reshape(-1)
        r0, r1 = a * DST_TILE, b * DST_TILE
        want = spmv_rows_plain(tables.row_ptr[r0 : r1 + 1], tables.src, c)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"spmv {what}: two runs differ in bits")
        if exact:
            if not torch.equal(got, want):
                raise AssertionError(f"spmv {what}: counts differ from the plain version")
        else:
            torch.testing.assert_close(got, want, rtol=SPMV_RTOL, atol=SPMV_ATOL)
        err = float((got - want).abs().max())
        spmv_err = max(spmv_err, err)
        log(f"spmv {what}: tiles [{a}, {b}) ok, max |kernel - plain| = {err:.3e}")
        return got

    full = check_spmv(t_in, contrib, 0, T, False, "in-edges full sweep")
    a, b = T // 10, T * 7 // 10
    part = check_spmv(t_in, contrib, a, b, False, "in-edges partial range")
    if not torch.equal(part, full[a * 512 : b * 512]):
        raise AssertionError("spmv partial range differs from the full sweep")
    slab = t_in.slab(0, T // 2)
    half = check_spmv(slab, contrib, 0, T // 2, False, "in-edges shard slab")
    if not torch.equal(half, full[: (T // 2) * 512]):
        raise AssertionError("spmv shard slab differs from the full tables")
    frontier = torch.zeros(V, dtype=torch.float32, device=dev)
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    frontier[torch.randperm(V, generator=gen)[:4096].to(dev)] = 1.0
    counts = check_spmv(t_out, frontier, 0, T, True, "out-edges BFS count sweep")
    part = check_spmv(t_out, frontier, a, b, True, "out-edges partial range")
    half = check_spmv(t_out.slab(T // 2, T), frontier, 0, T - T // 2, True, "out-edges shard slab")
    if not (torch.equal(part, counts[a * 512 : b * 512]) and torch.equal(half, counts[(T // 2) * 512 :])):
        raise AssertionError("spmv out-edge ranges differ from the full sweep")

    ids = (torch.stack([g.src, g.dst]) % V).to(torch.int32)
    dc_err = 0
    for c, table in ((V, ids), (1_000_003, (torch.stack([g.src, g.dst]) % 1_000_003).to(torch.int32))):
        for a, b in ((0, E), (E // 3, E // 2)):
            got = degree_count_cuda(table[:, a:b], torch.zeros(c, dtype=torch.int32, device=dev))
            want = degree_count_plain(table[:, a:b], torch.zeros(c, dtype=torch.int32, device=dev))
            err = int((got - want).abs().max())
            dc_err = max(dc_err, err)
            if err != 0:
                raise AssertionError(f"degree_count C={c} edges [{a}, {b}) differs from plain by {err}")
            log(f"degree_count C={c} edges [{a}, {b}) ok: max |kernel - plain| = {err}")
    del pr, slab

    # 4. main path ---------------------------------------------------------
    spmv_rows_cuda.launches = 0
    degree_count_cuda.launches = 0
    rep, made, wall = run_mix(core, alg, g, "cuda")
    launches = {"spmv": spmv_rows_cuda.launches, "degree_count": degree_count_cuda.launches}
    log(f"main path (cuda backend): {wall:.2f} s wall, launches {launches}, "
        f"fused packages {rep.total_fused}, stolen {rep.total_stolen}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"main path never launched the {name} kernel")
    pr_ref = alg.pagerank_reference(g, iters=PR_ITERS)
    dc_ref = alg.degree_count_reference(g.src.cpu().numpy(), g.dst.cpu().numpy(), V)
    for ex in made:
        res = ex.result()
        if isinstance(ex, alg.BFSExecutor):
            if not np.array_equal(res, alg.bfs_reference(g, ex.source)):
                raise AssertionError(f"BFS from {ex.source} differs from the oracle")
        elif isinstance(ex, alg.DegreeCountExecutor):
            if not np.array_equal(res, dc_ref):
                raise AssertionError("degree count differs from the oracle")
        else:
            if ex._iter != PR_ITERS:
                raise AssertionError(f"PageRank ran {ex._iter} iterations")
            np.testing.assert_allclose(res, pr_ref, rtol=PR_RTOL, atol=PR_ATOL)
    log(f"results: {len(made)} queries equal their numpy oracles")
    mrep, _, mwall = run_mix(core, alg, g, "modeled")
    if (rep.throughput_modeled(), rep.makespan_modeled_ns) != (
        mrep.throughput_modeled(), mrep.makespan_modeled_ns
    ):
        raise AssertionError("modeled throughput differs from the modeled backend's run")
    log(f"modeled: {rep.throughput_modeled():.6e} edges/s, makespan {rep.makespan_modeled_ns} ns "
        f"(equal on the modeled backend, {mwall:.2f} s wall there)")
    main = {
        "wall_s": wall,
        "edges": rep.total_edges,
        "measured_edges_per_s": rep.total_edges / wall,
        "throughput_modeled": rep.throughput_modeled(),
        "makespan_modeled_ns": rep.makespan_modeled_ns,
        "scale": SCALE,
    }
    log(json.dumps({"main_path": main}))

    # where the main path's device time goes: a second, profiled cuda run
    by_name, pwall = device_time_by_kernel(lambda: run_mix(core, alg, g, "cuda"))
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    log(json.dumps({"main_path_profile": {
        "wall_s": pwall, "device_busy_ms": busy,
        # busy over this profiled run's wall, and over the unprofiled run's
        "device_idle_share": 1.0 - busy / (pwall * 1e3),
        "device_idle_share_of_main_wall": 1.0 - busy / (wall * 1e3),
        "top_kernels_ms": {k[:60]: v for k, v in top},
    }}))

    # 5. timing at the main path's shapes --------------------------------------
    row_ptr = t_in.row_ptr
    k_ms = time_ms(lambda: spmv_tiles(t_in, contrib, 0, T))
    p_ms = time_ms(lambda: spmv_rows_plain(row_ptr, t_in.src, contrib))
    csr = torch.sparse_csr_tensor(
        row_ptr[: V + 1], t_in.src.to(torch.int64),
        torch.ones(E, dtype=torch.float32, device=dev), size=(V, V),
    )
    col = contrib.unsqueeze(1)
    lib_ms = time_ms(lambda: csr.matmul(col))
    torch.testing.assert_close(csr.matmul(col).squeeze(1), full[:V], rtol=SPMV_RTOL, atol=SPMV_ATOL)
    b_ms, b_by = bound_ms(E * 4 + row_ptr.numel() * 8 + V * 4 + T * 512 * 4, E, bw)
    kernels = [{
        "name": "spmv", "route": "cuda", "source": "src/repro_torch/csrc/spmv.cu",
        "replaces": "src/repro/kernels/spmv/spmv.py:47",
        "launches": launches["spmv"], "max_abs_err": spmv_err,
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
    }]
    counts = torch.zeros(V, dtype=torch.int32, device=dev)
    k_ms = time_ms(lambda: degree_count_cuda(ids, counts))
    p_ms = time_ms(lambda: degree_count_plain(ids, counts))
    flat = ids.reshape(-1)
    lib_ms = time_ms(lambda: torch.bincount(flat, minlength=V))
    b_ms, b_by = bound_ms(2 * E * 4 + V * 4, 2 * E, bw)
    kernels.append({
        "name": "degree_count", "route": "cuda", "source": "src/repro_torch/csrc/degree_count.cu",
        "replaces": "src/repro/kernels/degree_count/degree_count.py:64",
        "launches": launches["degree_count"], "max_abs_err": float(dc_err),
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
    })

    # 6. isolation -------------------------------------------------------------
    leaked = sorted(m for m in sys.modules if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
    if leaked:
        raise AssertionError(f"imported the JAX side: {leaked}")

    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
