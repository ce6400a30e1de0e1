#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

It needs one CUDA device and runs both of the port's paths at full size:
the graph engine at RMAT scale 20, and the two-tower retrieval server at
the full width of ``make_config()`` (18.54 GB of tables). For a quick check
at small sizes run ``tests/test_torch_cuda.py``. Phases, each raising on
failure:

1. environment — torch/CUDA versions, the card's name and power limit;
2. build — all four CUDA kernels from ``src/repro_torch/csrc`` (nvcc,
   sm_90a, one nvcc per source, in parallel);
3. graph kernels vs their plain PyTorch versions on the card, at the main
   path's shapes (RMAT scale 20, Graph500 parameters, seed 3);
4. graph main path — fig20's tenant mix (6 PageRank-pull, 4 BFS, 2
   degree-count sessions) through ``MultiQueryEngine`` with the ``cuda``
   backend, stealing and heterogeneous fusion on; every result checked
   against its numpy oracle, each kernel's launch count > 0, and the
   modeled throughput equal to the same run on the ``modeled`` backend;
5. graph timing — CUDA-event medians per kernel beside the plain version,
   one PyTorch library call and the card's lower bound;
6. retrieval server — with the RMAT graph freed: a 2^20-candidate corpus
   through the item tower, then 8 requests at each of batch 1, 4, 64 and
   512 (user tower, then ``score_topk`` with k=128), every result held
   against plain PyTorch on the card, both kernels' launch counts > 0, the
   planned group widths, wall latencies, a profile of one round, and both
   kernels' times at the server's shapes;
7. isolation — neither JAX nor the JAX package was imported.

The kernels' times go out as one JSON line. The last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import gc
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

# the retrieval server (examples/serve_retrieval.py) at the full width of
# configs/two_tower_retrieval.py::make_config(), with the reference's cell
# shapes (launch/steps.py): retrieval_cand is one query against 2^20
# candidates with top_k=128, serve_p99 a batch of 512
N_ITEMS = 1_048_576
CORPUS_CHUNK = 65_536
BATCHES = (1, 4, 64, 512)  # retrieval_cand, the example's 4 and 64, serve_p99
REQUESTS = 8               # per batch size
TOP_K = 128
# the example's (batch, queue_depth) pairs, then retrieval_cand's and serve_p99's
PLAN_CASES = ((4, 1), (64, 1), (4, 32), (1, 1), (512, 1))
# float32 dot products of unit-norm 256-vectors, summed in another order:
# the JAX package's scoring tolerance (tests/test_kernels.py)
SCORE_RTOL = SCORE_ATOL = 1e-5
# tower outputs (unit rows, entries ~0.06) whose bag sums differ in order
# only (the plain version's atomic adds): as the CPU parity tests hold them
EMB_RTOL, EMB_ATOL = 1e-5, 1e-6

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


def graph_path(dev: torch.device, bw: float) -> list[dict]:
    """Phases 3-5: the graph kernels against their plain versions, fig20's
    mix through the ``cuda`` backend, and the kernels' times."""
    from repro_torch import algorithms as alg
    from repro_torch import core
    from repro_torch.graph import rmat_graph
    from repro_torch.kernels.degree_count import degree_count_cuda, degree_count_plain
    from repro_torch.kernels.spmv import (
        DST_TILE, build_tiles, spmv_rows_cuda, spmv_rows_plain, spmv_tiles,
    )

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
    return kernels


@torch.no_grad()
def retrieval_path(dev: torch.device, bw: float) -> list[dict]:
    """Phase 6: the two-tower retrieval server at ``make_config()``'s full
    width. Builds the 2^20-candidate corpus with the item tower, answers
    REQUESTS requests at each batch size (user tower, then ``score_topk``),
    holds every result against plain PyTorch on the card, and times both
    kernels at the shapes the server gave them."""
    from torch.nn import functional as F

    from repro_torch import core
    from repro_torch.configs import get_arch
    from repro_torch.kernels.embedding_bag import embedding_bag_cuda, embedding_bag_plain
    from repro_torch.kernels.scoring import score_topk, scoring_cuda, scoring_plain
    from repro_torch.launch.steps import RECSYS_SHAPES
    from repro_torch.models.recsys import TwoTower
    from repro_torch.serving import plan_group_width

    if (RECSYS_SHAPES["retrieval_cand"]["n_candidates"], RECSYS_SHAPES["retrieval_cand"]["batch"],
            RECSYS_SHAPES["serve_p99"]["batch"]) != (N_ITEMS, BATCHES[0], BATCHES[-1]):
        raise AssertionError("the cell shapes moved: update N_ITEMS and BATCHES")
    cfg = get_arch("two-tower-retrieval").make_config()
    d = cfg.tower_mlp[-1]
    t0 = time.perf_counter()
    model = TwoTower(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    tables = [*model.user_tables.values(), *model.item_tables.values()]
    table_bytes = sum(t.numel() * t.element_size() for t in tables)
    log(f"retrieval: {cfg.name} tables {table_bytes / 1e9:.2f} GB "
        f"(largest {max(t.numel() for t in tables)} floats), built in {time.perf_counter() - t0:.1f} s")

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def features(fields, b: int, last_rows: int = 0) -> dict:
        """Ids drawn from the seed; multi-hot fields carry weights, their last
        quarter 0 (the fixed hot-size's padding). The first ``last_rows``
        rows hold only id vocab - 1: the tables' last rows."""
        out = {}
        for f in fields:
            ids = torch.randint(0, f.vocab, (b, f.multi_hot), generator=gen, device=dev, dtype=torch.int32)
            ids[:last_rows] = f.vocab - 1
            out[f.name] = ids
            if f.multi_hot > 1:
                w = torch.rand(b, f.multi_hot, generator=gen, device=dev)
                w[:, f.multi_hot - f.multi_hot // 4 :] = 0.0
                out[f.name + "_w"] = w
        return out

    def plain_tower(tables_, tower, feats, fields, b: int) -> torch.Tensor:
        """The tower with the plain EmbeddingBag: the model's weights, no kernel."""
        cols = []
        for f in fields:
            segs = torch.arange(b, device=dev).repeat_interleave(f.multi_hot)
            w = feats.get(f.name + "_w")
            cols.append(embedding_bag_plain(
                tables_[f.name], feats[f.name].reshape(-1), segs,
                None if w is None else w.reshape(-1), b,
            ))
        out = tower(torch.cat(cols, dim=-1))
        return out / torch.linalg.vector_norm(out, dim=-1, keepdim=True).clamp_min(1e-6)

    # set-up: every request's and every item's features, made on the card;
    # the first corpus chunk and each batch size's first request read the
    # tables' last rows
    item_feats = features(cfg.item_fields, N_ITEMS, last_rows=4)
    user_feats = {b: [features(cfg.user_fields, b, last_rows=1 if r == 0 else 0) for r in range(REQUESTS)]
                  for b in BATCHES}
    torch.cuda.synchronize()

    # the main path: corpus, then the requests ------------------------------------
    scoring_cuda.launches = 0
    embedding_bag_cuda.launches = 0
    t0 = time.perf_counter()
    corpus = torch.empty(N_ITEMS, d, device=dev)
    for c0 in range(0, N_ITEMS, CORPUS_CHUNK):
        chunk = {k: v[c0 : c0 + CORPUS_CHUNK] for k, v in item_feats.items()}
        corpus[c0 : c0 + CORPUS_CHUNK] = model.item_embedding(chunk, CORPUS_CHUNK)
    torch.cuda.synchronize()
    corpus_s = time.perf_counter() - t0
    answers, lat = {}, {b: [] for b in BATCHES}
    for b in BATCHES:
        for r, feats in enumerate(user_feats[b]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            u = model.user_embedding(feats, b)
            vals, idx = score_topk(u, corpus, TOP_K)
            torch.cuda.synchronize()
            lat[b].append(time.perf_counter() - t0)
            answers[b, r] = (u, vals, idx)
    launches = {"scoring": scoring_cuda.launches, "embedding_bag": embedding_bag_cuda.launches}
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"the retrieval server never launched the {name} kernel")
    log(f"retrieval main path: corpus {N_ITEMS} x {d} in {corpus_s:.3f} s, "
        f"{sum(map(len, lat.values()))} requests, launches {launches}")

    # every result against plain PyTorch on the card ---------------------------
    chunk = {k: v[:CORPUS_CHUNK] for k, v in item_feats.items()}
    want = plain_tower(model.item_tables, model.item_tower, chunk, cfg.item_fields, CORPUS_CHUNK)
    torch.testing.assert_close(corpus[:CORPUS_CHUNK], want, rtol=EMB_RTOL, atol=EMB_ATOL)
    swapped = 0
    for (b, r), (u, vals, idx) in answers.items():
        u_plain = plain_tower(model.user_tables, model.user_tower, user_feats[b][r], cfg.user_fields, b)
        torch.testing.assert_close(u, u_plain, rtol=EMB_RTOL, atol=EMB_ATOL)
        s_plain = scoring_plain(u_plain, corpus)
        pv, pi = torch.topk(s_plain, TOP_K, dim=-1)
        torch.testing.assert_close(vals, pv, rtol=SCORE_RTOL, atol=SCORE_ATOL)
        # an index may differ from the plain one only between near-equal
        # scores: each chosen candidate scores as the plain rank's value
        torch.testing.assert_close(s_plain.gather(1, idx), pv, rtol=SCORE_RTOL, atol=SCORE_ATOL)
        swapped += int((idx != pi).sum())
        del s_plain
    log(f"retrieval results: the corpus chunk with the tables' last rows and all "
        f"{len(answers)} answers match plain PyTorch; {swapped} of "
        f"{sum(b * TOP_K * REQUESTS for b in BATCHES)} top-k indices sit elsewhere among near-equal scores")

    plan = {f"batch={b},queue={q}": plan_group_width(
        core.XEON_E5_2660V4, batch=b, cache_len=N_ITEMS, n_kv_heads=1,
        head_dim=d, n_layers=1, queue_depth=q) for b, q in PLAN_CASES}
    med = {b: float(np.median(lat[b])) for b in BATCHES}
    log(json.dumps({"retrieval_path": {
        "table_bytes": table_bytes, "n_candidates": N_ITEMS, "top_k": TOP_K,
        "corpus_build_s": corpus_s,
        "latency_ms_median": {str(b): med[b] * 1e3 for b in BATCHES},
        "latency_ms_all": {str(b): [x * 1e3 for x in lat[b]] for b in BATCHES},
        "requests_per_s": {str(b): 1.0 / med[b] for b in BATCHES},
        "queries_per_s": {str(b): b / med[b] for b in BATCHES},
        "launches": launches, "topk_index_swaps": swapped,
        "planned_group_width_xeon_model": plan,
    }}))

    # where one round of requests (one per batch size) spends device time
    def one_round():
        for b in BATCHES:
            score_topk(model.user_embedding(user_feats[b][0], b), corpus, TOP_K)

    by_name, pwall = device_time_by_kernel(one_round)
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    log(json.dumps({"retrieval_round_profile": {
        "wall_s": pwall, "device_busy_ms": busy, "device_idle_share": 1.0 - busy / (pwall * 1e3),
        "top_kernels_ms": {k[:60]: v for k, v in top},
    }}))

    # kernel times at the server's shapes -----------------------------------------
    score_err, score_shapes = 0.0, []
    for b in (1, 64, 512):
        q = answers[b, 0][0]
        got, want = scoring_cuda(q, corpus), scoring_plain(q, corpus)
        torch.testing.assert_close(got, want, rtol=SCORE_RTOL, atol=SCORE_ATOL)
        score_err = max(score_err, float((got - want).abs().max()))
        del got, want
        b_ms, b_by = bound_ms(4 * (b * d + N_ITEMS * d + b * N_ITEMS), 2 * b * N_ITEMS * d, bw)
        score_shapes.append({
            "shape": f"B={b} N={N_ITEMS} D={d}",
            "ms": time_ms(lambda: scoring_cuda(q, corpus)),
            "plain_ms": time_ms(lambda: scoring_plain(q, corpus)),
            "library_ms": time_ms(lambda: torch.matmul(q, corpus.T)),
            "bound_ms": b_ms, "bound_by": b_by,
        })
    main_shape = score_shapes[-1]  # serve_p99: the most device time per request
    kernels = [{
        "name": "scoring", "route": "cuda", "source": "src/repro_torch/csrc/scoring.cu",
        "replaces": "src/repro/kernels/scoring/scoring.py:41",
        "launches": launches["scoring"], "max_abs_err": score_err,
        **{k: main_shape[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "at": main_shape["shape"], "shapes": score_shapes,
    }]

    bag_err, bag_shapes = 0.0, []
    for side, field, feats, b in (("item", "item_tags", item_feats, N_ITEMS),
                                  ("user", "user_history", user_feats[512][0], 512)):
        table = (model.item_tables if side == "item" else model.user_tables)[field]
        ids, w = feats[field].reshape(-1), feats[field + "_w"].reshape(-1)
        hot = ids.numel() // b
        segs = torch.arange(b, dtype=torch.int32, device=dev).repeat_interleave(hot)
        got = embedding_bag_cuda(table, ids, segs, w, b)
        want = embedding_bag_plain(table, ids, segs, w, b)
        torch.testing.assert_close(got, want, rtol=EMB_RTOL, atol=EMB_ATOL)
        bag_err = max(bag_err, float((got - want).abs().max()))
        del got, want
        offsets = torch.arange(0, ids.numel(), hot, dtype=torch.int32, device=dev)
        rows = torch.unique(ids).numel()  # each touched row read once
        n = ids.numel()
        b_ms, b_by = bound_ms(4 * (rows * d + 3 * n + b * d), 2 * n * d, bw)
        bag_shapes.append({
            "shape": f"{field}: {b} bags x {hot} ids, {rows} distinct rows of {table.shape[0]}",
            "ms": time_ms(lambda: embedding_bag_cuda(table, ids, segs, w, b)),
            "plain_ms": time_ms(lambda: embedding_bag_plain(table, ids, segs, w, b)),
            "library_ms": time_ms(lambda: F.embedding_bag(
                ids, table, offsets, mode="sum", per_sample_weights=w)),
            "bound_ms": b_ms, "bound_by": b_by,
        })
    main_shape = bag_shapes[0]  # the corpus's item_tags field
    kernels.append({
        "name": "embedding_bag", "route": "cuda", "source": "src/repro_torch/csrc/embedding_bag.cu",
        "replaces": "src/repro/kernels/embedding_bag/embedding_bag.py:59",
        "launches": launches["embedding_bag"], "max_abs_err": bag_err,
        **{k: main_shape[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "at": main_shape["shape"], "shapes": bag_shapes,
    })
    return kernels


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() != 1:
        print(f"chip_smoke: needs one CUDA device, sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in full float32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    # 1. environment ---------------------------------------------------------
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    log(smi)
    bw = hbm_bytes_per_s(smi)

    # 2. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    secs = _build.build("spmv", "degree_count", "scoring", "embedding_bag")
    log(f"build: {time.perf_counter() - t0:.2f} s wall, per source {secs} (nvcc sm_90a)")
    for name, text in _build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # 3-5. the graph engine: kernels, main path, timing -----------------------
    kernels = graph_path(dev, bw)
    gc.collect()
    torch.cuda.empty_cache()  # the RMAT graph is gone; the retrieval tables need the room

    # 6. the retrieval server at full width ---------------------------------------
    t0 = time.perf_counter()
    kernels += retrieval_path(dev, bw)
    log(f"retrieval phase: {time.perf_counter() - t0:.1f} s")

    # 7. isolation -------------------------------------------------------------
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
