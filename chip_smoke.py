#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

It needs one CUDA device and runs the port's paths at full size: the
graph engine at RMAT scale 20, on the SNAP surrogates at the SNAP graphs'
own sizes and under live edge ingest at RMAT scale 20, the two-tower
retrieval server at the full width of ``make_config()`` (18.54 GB of
tables), TinyLlama-1.1B serving at full width and depth, MoE serving
(grok-1, arctic) at full width with depth cut, and TinyLlama-1.1B training
at full width and depth, then the LM smoke configs (head dim 16) on the
card, then the GNN family (MeshGraphNet, PNA, SchNet, GraphCast) trained at
the published widths, then the two-tower model trained at the full width of
``make_config()``, then the dry-run's 42 cells and the paper's own
graph-engine cells at V = 2^26, E = 2^30. For a quick check at small
sizes run ``tests/test_torch_cuda.py``. Phases, each raising on failure:

1. environment — torch/CUDA versions, the card's name and power limit;
2. build — all five CUDA kernels from ``src/repro_torch/csrc`` (nvcc,
   sm_90a, one nvcc per source, in parallel);
3. graph kernels vs their plain PyTorch versions on the card, at the main
   path's shapes (RMAT scale 20, Graph500 parameters, seed 3); degree_count
   equal in bits on the whole endpoint table, a range, the 16 Ki-edge
   package whose src row is one id, a range from an odd edge, and ids mod
   1,000,003, by the wrapper's choice and with each of its two kernels
   forced; ``ops.degree_count`` over the whole graph equal to the oracle;
4. graph main path — fig20's tenant mix (6 PageRank-pull, 4 BFS, 2
   degree-count sessions) through ``MultiQueryEngine`` with the ``cuda``
   backend, stealing and heterogeneous fusion on; every result checked
   against its numpy oracle, each kernel's launch count > 0, and the
   modeled throughput equal to the same run on the ``modeled`` backend;
5. graph timing — CUDA-event medians per kernel beside the plain version,
   one PyTorch library call and the card's lower bound; for spmv also each
   of the 16 slices the main path's gang of 16 launches (T/16 tiles), the
   out-edge sweep, and a gather-only probe (the floor of the layout); the
   main path's spmv launches by size in tiles (from its profiled run); for
   degree_count also the device time of each of the 1,024 16 Ki-edge
   packages launched alone (the main path's launch shape: mean and worst);
6. real-size data sets — with the RMAT graph freed: ``soc-LiveJournal1``
   (4,194,304 vertices, 67,108,864 edges) and ``roadNet-CA`` (1,962,801,
   7,845,600) from ``load_dataset(name, scale_div=1)`` on the card; on
   each, fig12's PageRank-pull mix and fig13's BFS mix (8 sessions,
   ``policy="scheduler"``, stealing on) through the ``cuda`` backend, every
   result equal to its oracle, the modeled numbers equal to the
   ``modeled`` backend's, spmv launched; per run the wall, measured
   edges/s, a profiled run's device busy and idle, spmv's device ms and
   launches, and the peak memory. On LiveJournal also spmv's full in-edge
   sweep against its plain version (timed beside it) and
   ``ops.degree_count`` of the whole graph against the numpy oracle;
7. dynamic ingest — fig22's writer and readers at RMAT scale 20, seed 3:
   the base snapshot holds the first 85% of the edge stream, a
   ``GraphEpochLog`` publishes the rest in 6 batches while 8 reader
   sessions of 2 queries run fig22's PR/BFS mix (pool 8, fusion and
   stealing on, ``dynamic=True``) through the ``cuda`` backend. Every
   record's epoch equals its executor's snapshot's, the readers spread over
   two epochs or more, every reader equals its own snapshot's oracle, 6
   epochs are published, the modeled numbers equal the same run on the
   ``modeled`` backend (which first picks the cadence factor: 1 unless
   fig22's cadence fails to spread the readers); each publish's host
   seconds, each epoch's table build and the memory after each publish are
   printed; the static variant (no writer) runs too;
8. retrieval server — with the snapshots freed: a 2^20-candidate corpus
   through the item tower, then 8 requests at each of batch 1, 4, 64 and
   512 (user tower, then ``score_topk`` with k=128), every result held
   against plain PyTorch on the card, both kernels' launch counts > 0 and
   both scoring kernels' (the CUDA-core stream at batch 1 and 4, the
   3xTF32 tensor-core kernel at 64 and 512), the planned group widths, wall
   latencies, a profile of one round, and the kernels' times at the
   server's shapes (scoring also at batch 16; EmbeddingBag also as the
   profiler's device time per call, with its kernel launches per call);
9. LM serving — with the retrieval tables freed: TinyLlama-1.1B
   (``configs/tinyllama_1_1b.py::make_config()``, bf16, random weights
   from the seed) prefills 8 prompts of 2048 tokens through the
   tensor-core flash-attention kernel (wgmma products fed by TMA, split-P;
   22 launches, and the profiled prefill must show it), decodes 32 greedy
   steps, and runs
   the same prefill again with the kernel's plain version passed as the
   attention: logits and caches within bf16 tolerances, greedy tokens
   equal wherever the plain path's top-2 margin exceeds the logits'
   difference. Then ``ServingEngine`` serves 8 requests (prompts of 16–48
   tokens, 16 new tokens each) by continuous batching. The kernel is held
   against its plain version on layer 0's q/k/v at the served shape and at
   ``prefill_32k``'s sequence (B=1, S=32768) in bf16, and at the served
   shape with B=2 in float32 (the CUDA-core kernel), each timed beside the
   plain version and ``scaled_dot_product_attention``;
10. MoE serving — with TinyLlama freed: grok-1-314b
    (``configs/grok_1_314b.py::make_config()``, dense dispatch, bf16,
    random weights from the seed) at full width, 4 of its 64 layers (42.6
    GB), prefills 8 prompts of 2048 tokens through the flash kernel (Dh =
    128, 6 query heads a KV head; 4 launches), decodes 32 greedy steps and
    runs the engine on the LM phase's 8 requests; then, with grok freed,
    arctic-480b (128 experts and the dense residual) at full width, 1 of 35
    layers (28.1 GB), prefills the same way (1 launch) and decodes 8 steps.
    For each: (a) layer 0's ``moe_block`` on the prefill's own ``ln2``
    activations against a float32 oracle written from the definition
    (routing and kept pairs equal, outputs within a bf16 allowance), the
    gather dispatch at 16 groups against both on the tokens that fit under
    both; (b) the same prefill through the kernel's plain version: tokens
    whose routing first differs a layer within a near-tie share, logits of
    sequences routed alike within a relative RMS, greedy tokens equal
    outside near-ties; (c) the kernel against its plain version at the
    served shape, timed beside ``scaled_dot_product_attention``; (d) one
    launch a layer. (token, choice) pairs dropped per layer, a profiled
    prefill and decode step and the peak memory are printed;
11. LM training — with arctic freed: TinyLlama-1.1B at full width and depth
    (``make_config()``: float32 masters, bf16 compute, AdamW, remat, 8
    microbatches; ``train_4k``'s sequence of 4096, the batch cut from 256
    to 16) on ``TokenStream(seed=0)``. (a) the attention's gradient
    (``FlashAttention``: the kernel's forward, the plain blocked backward)
    against autograd through the kernel's plain version at TinyLlama's and
    grok-1's heads, float32 and bf16, and the kernel's forward, the
    backward and both together at the trained shape timed beside the plain
    version and ``scaled_dot_product_attention``; (b) step 0's loss and
    gradient tree on one microbatch through the kernel path and through the
    plain-attention path, each against a float32 step (loss within a bf16
    step; gradients no further from it than the plain path's, by the LM
    phase's noise ratios); (c) ``train_lm`` for 6 steps (the loss falls),
    and a run with a checkpoint every 3 stopped after 3 and resumed whose
    losses and weights equal the uninterrupted run's; (d) 352 flash
    launches a step (22 layers × 8 microbatches × 2 under remat), and one
    more step profiled (it must show the tensor-core kernel): step seconds,
    tokens/s, the device's idle share, the largest kernels, the peak memory;
12. small head dims — the flash kernel at the LM smoke configs' head dim
    (16; B=8, S=2048, H=4 over K=2) in bf16 and float32 against its plain
    version, timed beside it and ``scaled_dot_product_attention``, one
    kernel a call; then each of the five smoke configs (grok-1 and arctic
    under both dispatches) prefills and takes one AdamW train step on the
    card (one launch a layer; two a layer and microbatch under remat) equal
    to the same on the CPU, and ``launch.train.main([])`` runs with its
    defaults on the card (the loss falls, one launch a layer and step);
13. GNN family — (a) each GNN smoke config (MeshGraphNet, PNA, SchNet,
    GraphCast; tests/test_arch_smoke.py's 48-node, 160-edge, 4-graph
    batch; GraphCast also owner-blocked, P = 4) forward and one AdamW
    ``gnn_train_step`` on the card equal to the CPU; (b)
    ``examples/gnn_train.py``'s loop (MeshGraphNet 4 × 64 on
    ``rmat_graph(11, seed=1)``, 60 steps) on the card, its first 5 losses
    within 1e-5 of a CPU run's (the same steps with TF32 products past it)
    and the loss falling; (c) each config's
    ``make_config`` at its reference shape (``minibatch_lg``: 169,984 nodes,
    168,960 RMAT edges, 602 features; SchNet ``molecule``: 128 molecules of
    30 atoms) laid out as the reference's ``gnn_abstract_batch``, 5 AdamW
    steps: step 0's loss within 1e-6 of a float64 copy's (a forward with
    TF32 products past it), the losses
    finite and falling, step ms, message-passing edges/s, peak memory and a
    profiled step (device time by kernel, idle share); GraphCast also
    owner-blocked at P = 512 (its loss equal to the flat forward's on the
    same edges, then 3 steps). None of the five kernels runs here: their
    counts stay 0;
14. two-tower training — (a) ``EmbeddingBagFunction`` (the kernel's
    forward, the plain backward) against autograd through the plain
    version on the card, forward and both gradients, at ``user_history``'s
    shape (16,384 bags of 32 Zipf ids), ``item_tags``' (2^20 bags of 8) and
    on ``jnp.take``'s out-of-range ids (-1, -V, V, V + 5: NaN bags), one
    launch a forward, the backward's device ms; (b) three
    ``recsys_train_step``s of the smoke config on the card equal to the
    CPU; (d) ``recsys_serve_step`` at ``make_config()``'s full width
    (18.54 GB of tables, ``TwoTower(seed=3)``) at serve_p99 (512) and
    serve_bulk (262,144) against its plain version, ms a call; (c) 5 AdamW
    steps (the config's ``OPTIMIZER``, lr 1e-3; clipping and AdamW in
    place) at that width on ``InteractionStream`` batches, ``train_batch``
    cut from 65,536 to 16,384: step 0's loss and gradient norm within 1e-5
    of a control pass through the plain EmbeddingBag, the losses, step ms,
    examples/s, peak memory, 6 EmbeddingBag launches a step and a profiled
    step (device ms by kernel, each part's ms, idle share);
15. the dry-run slice — (a) ``launch.dryrun.run_cell`` for every cell
    (the 40 assigned and the graph engine's 2) on the single-pod plan with
    the trip analysis, in ``DRYRUN_WORKERS`` processes (meta traces, CPU
    only) while (b) runs: 42 records (written to ``build/dryrun/``), each
    cell's ``lower_s``, FLOPs and whole-program argument GB beside the
    card's memory; full-depth FLOPs equal to the trip-scaled ones in every
    LM and GNN cell, except the MoE configs' ``train_4k``, whose trips (one
    microbatch, as the reference runs them) cost more in the dense
    dispatch, and which must then scale exactly from trips at their own
    microbatch count; (b)
    ``paper-graph-engine`` at the V = 2^26, E = 2^30 of its cells'
    arguments: RMAT edges drawn on the card (Graph500's recipe, seed 3),
    ``out_deg`` through the degree_count kernel equal to ``torch.bincount``,
    one ``pr_iteration`` through the cell's step (median of 20 timed) and
    ``0.15/V + 0.85 · spmv(build_tiles(src, dst, V), contrib)`` each row
    within the float32 bound of a float64 sum, then ``bfs_expand`` from the
    vertex of highest out-degree to its fixed point, each level's new
    vertices equal to the spmv kernel's expansion of the frontier; step ms,
    edges/s, levels, reached vertices, peak GB. The cells' steps are plain
    PyTorch (``index_add_``, gathers, as the reference's ``segment_sum``
    lies outside any ``pallas_call``): every kernel's count, zeroed before
    each step and read after it, stays 0; the checks' own spmv and
    degree_count launches are counted apart;
16. isolation — neither JAX nor the JAX package was imported.

The kernels' times go out as one JSON line. The last line is
``{"ok": true, "device": {...}}``. Without a CUDA device, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import gc
import json
import multiprocessing
import os
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

# the real-size data sets: fig12's PageRank-pull and fig13's BFS session
# mixes (benchmarks/fig12_pr_sessions_real.py, fig13_bfs_sessions_real.py)
# on the SNAP surrogates at the SNAP graphs' own sizes (name -> scale_div)
DATASETS = {"soc-LiveJournal1": 1, "roadNet-CA": 1}
REAL_MIXES = ("pr_pull", "bfs")
REAL_SESSIONS = 8
# fig22's live ingest (benchmarks/fig22_dynamic.py) at RMAT scale 20: the
# base holds the first 85% of the edge stream, the rest arrives in 6 batches
# every INTERVAL_NS while 8 reader sessions of 2 queries arrive
# ARRIVAL_GAP_NS apart (both modeled ns)
DYN_SCALE, DYN_SEED = 20, 3
DYN_POOL, DYN_SESSIONS, DYN_QUERIES = 8, 8, 2
DYN_ALGOS = ("pr_pull", "bfs", "pr_push", "bfs", "pr_pull", "bfs", "pr_pull", "bfs")
BASE_FRACTION, N_BATCHES = 0.85, 6
INTERVAL_NS, ARRIVAL_GAP_NS = 6e5, 4.5e5

# f32 sums of the same positive terms in another order (warp tree vs the
# plain version's atomic adds): relative error grows like sqrt(row length)
# times float32 epsilon, ~2e-5 for the longest rows of this graph
SPMV_RTOL, SPMV_ATOL = 1e-4, 1e-12
PR_RTOL, PR_ATOL = 2e-4, 1e-8  # the JAX package's PageRank tolerance
DC_PATHS = ("runs", "private")  # the degree-count kernels, each forced beside the dispatch

# the retrieval server (examples/serve_retrieval.py) at the full width of
# configs/two_tower_retrieval.py::make_config(), with the reference's cell
# shapes (launch/steps.py): retrieval_cand is one query against 2^20
# candidates with top_k=128, serve_p99 a batch of 512
N_ITEMS = 1_048_576
CORPUS_CHUNK = 65_536
BATCHES = (1, 4, 64, 512)  # retrieval_cand, the example's 4 and 64, serve_p99
SCORING_TIMED = (1, 4, 16, 64, 512)  # the server's batches and 16
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

# TinyLlama-1.1B serving: 8 prompts of 2048 tokens, then 32 greedy steps;
# the engine's 8 requests with prompts of 16-48 tokens and 16 new tokens
LM_ARCH = "tinyllama-1.1b"
LM_BATCH, LM_PROMPT, LM_NEW = 8, 2048, 32
ENGINE_REQUESTS, ENGINE_MAX_BATCH, ENGINE_MAX_LEN, ENGINE_NEW = 8, 8, 1024, 16
ENGINE_PROMPT = (16, 48)
ENGINE_CHECKED = 2  # requests whose tokens are replayed through prefill + decode
# bf16 attention outputs of the same float32 math summed in another order
# round one bf16 step apart at most: torch.testing's bf16 defaults
FLASH_BF16_RTOL, FLASH_BF16_ATOL = 1.6e-2, 1e-5
FLASH_F32_TOL = 2e-5  # the JAX package's flash tolerance (tests/test_kernels.py)
# Two bf16 runs of 22 layers whose roundings differ anywhere drift apart by
# the network's own bf16 noise, which no fixed tolerance bounds, so both
# paths are held against the same weights in float32: the kernel path's
# logits and caches may stray from it no further than the plain path's, up
# to these ratios of RMS and largest deviation
NOISE_RMS_RATIO, NOISE_MAX_RATIO = 1.25, 1.5

# MoE serving at full width, depth cut to fit one card (arch, layers kept of
# the config's, greedy decode steps, whether the engine runs): grok-1 4 of 64
# layers (42.6 GB of bf16 weights), arctic 1 of 35 (28.1 GB); 8 prompts of
# 2048 tokens, the LM phase's engine constants
MOE_RUNS = (("grok-1-314b", 4, 32, True), ("arctic-480b", 1, 8, False))
MOE_BATCH, MOE_PROMPT = 8, 2048
MOE_GATHER_GROUPS = 16  # the configs' dispatch_groups for the gather dispatch
# moe_block in bf16 against a float32 oracle on the same bf16 weights and
# tokens: each product rounds to bf16 (the expert's g, u, h and output, the
# gate), so an output sits a few bf16 half-steps (2^-9 to 2^-8 relative) of
# its terms' size from the oracle (where terms cancel, far more than a step
# of its own size), plus the roundings of h carried through the sum over
# d_ff: |diff| <= MOE_RTOL * scale + MOE_ATOL_RMS * RMS(oracle), where scale
# is the sum of the absolute values of the output's terms
MOE_RTOL, MOE_ATOL_RMS = 2**-6, 2**-5
# the prefill through the kernel against the prefill through its plain
# version, both bf16: a token's routing may first differ (in no more than
# this share of tokens a layer) only where bf16 noise meets a near-tie of
# router probabilities or the capacity edge; the logits of a sequence whose
# last token routed alike in every layer stay within this RMS of the plain
# path's, relative to their own RMS
MOE_FLIP_SHARE, MOE_LOGIT_REL_RMS = 0.05, 0.05

# LM training at TinyLlama-1.1B's full width and depth: float32 masters,
# bf16 compute, AdamW (the config's OPTIMIZER), train_4k's sequence and the
# config's 8 microbatches, the batch cut from 256 to 16 (two sequences a
# microbatch); train_lm runs 6 steps, and a second run with a checkpoint
# every 3 stops after 3 and resumes
TRAIN_BATCH, TRAIN_STEPS, TRAIN_CKPT_EVERY = 16, 6, 3
# (a) the attention's gradient (the kernel's forward, the plain blocked
# backward) against autograd through the kernel's plain version, at (B, S,
# H, K, Dh): TinyLlama's heads and grok-1's. float32: the same float32 math
# in another order, within 1e-4 of each gradient's largest entry. bf16: both
# cast float32 gradients to bf16, and the backward's D = rowsum(dO * O)
# reads the kernel's bf16 output, which may sit a bf16 step from the plain
# one: within two bf16 steps (2**-6) relative, 1e-2 of the largest entry
GRAD_SHAPES = ((1, 2048, 32, 4, 64), (1, 2048, 48, 8, 128))
GRAD_F32_ATOL_REL, GRAD_BF16_RTOL, GRAD_BF16_ATOL_REL = 1e-4, 2**-6, 1e-2
# (b) step 0's loss on one microbatch through each bf16 path within a bf16
# step (2**-8) of the float32 loss: a mean of 8192 float32 cross-entropies
# of bf16 logits; the gradients by NOISE_RMS_RATIO / NOISE_MAX_RATIO
TRAIN_LOSS_RTOL = 2**-8
# (c) the resumed run against the uninterrupted one: the same steps from
# the same bits (a checkpoint holds float32 exactly); where a sum's order
# changes from run to run (atomics), float32 noise of ~1e-7 relative in a
# gradient moves AdamW's step by as much relative, ~1e-10 of a weight, and
# the losses by less than RESUME_LOSS_RTOL
RESUME_LOSS_RTOL, RESUME_PARAM_ATOL = 1e-4, 1e-5

# the LM smoke configs' head dim on the card: the kernel at their head
# grouping (H=4 over K=2, Dh=16) at the served batch and length, and their
# block_kv for its plain version; each config's prefill (2 x 77 tokens) and
# one train step (4 x 40 tokens, 2 microbatches, remat, AdamW with eps 1e-4:
# tests/test_torch_train.py) against the CPU, the MoE ones under both
# dispatches, at the card tests' tolerances
SMALL_DH_SHAPE = (8, 2048, 4, 2, 16)
SMALL_DH_BLOCK_KV = 16
SMALL_DH_CASES = (("tinyllama-1.1b", None), ("stablelm-1.6b", None), ("granite-34b", None),
                  ("grok-1-314b", "dense"), ("grok-1-314b", "gather"),
                  ("arctic-480b", "dense"), ("arctic-480b", "gather"))
SMALL_DH_PROMPT, SMALL_DH_TRAIN_SEQ = 77, 40

# the GNN family (models/gnn): (a) each smoke config on the smoke batch of
# tests/test_arch_smoke.py (48 nodes, 160 edges, 4 graphs; GraphCast also
# owner-blocked, P = 4 blocks of 12 nodes, 48 edge slots, 40 valid) against
# the CPU: forward, loss, gradient norm and weights after one AdamW step,
# tests/_torch_gnn.py's card_equals_cpu at its tolerances
GNN_ARCHS = ("meshgraphnet", "pna", "schnet", "graphcast")
# (b) examples/gnn_train.py's loop: MeshGraphNet 4 x 64 on rmat_graph(11,
# seed=1), GraphBatchStream(batch_nodes=32, fanouts=(6, 4), d_feat=16),
# AdamW lr 1e-3 warmup 5 decay 100, clip 1.0, 60 steps; its first steps
# against a CPU run of the same loop within GNN_LOOP_RTOL, and the same
# steps with TF32 products (the control) past it. Readings on an H100:
# 1.2e-7 and 1.9e-7 from the CPU, the control 5.9e-3 to 8.3e-3 (PERF.md §6)
GNN_LOOP_STEPS, GNN_LOOP_CPU_STEPS, GNN_LOOP_RTOL = 60, 5, 1e-5
# (c) each config's make_config(shape) at its reference shape (GNN_SHAPES),
# laid out as the reference's gnn_abstract_batch (pad_to(512) nodes and
# edges, the padded tail masked), AdamW (the configs' OptimizerConfig), 5
# steps; step 0's loss against a float64 copy of the same module within
# GNN_F64_RTOL, and the float32 forward with TF32 products (the control)
# past it. Readings on an H100: float32 5.4e-9 to 1.3e-7 from float64, the
# controls 2.9e-5 (GraphCast) to 1.9e-4 (MeshGraphNet) (PERF.md §6)
GNN_FULL = {"meshgraphnet": "minibatch_lg", "pna": "minibatch_lg", "graphcast": "minibatch_lg",
            "schnet": "molecule"}
GNN_STEPS = 5
GNN_F64_RTOL = 1e-6
GNN_RMAT_SCALE = 18  # the edges of minibatch_lg: rmat_edges(18, seed=3), ends mod n_nodes
GNN_MOLECULE_ATOMS, GNN_BOND = 30, 1.5  # atoms a molecule (3,840 in 128), Å between chained atoms
# GraphCast's owner-blocked path: the reference's default P = 512 blocks,
# Epb = pad_to(ceil(E / P), 128) = 384 slots, E / P = 330 valid a block with
# dst inside the owner's rows; its loss against the flat forward's on the
# same edges (the same sums in another order), then GNN_BLOCKED_STEPS steps
GNN_BLOCKS, GNN_BLOCKED_STEPS = 512, 3

# two-tower training (launch/steps.py::recsys_train_step) at make_config()'s
# full width: 18.54 GB of float32 tables, AdamW (the config's OPTIMIZER),
# train_batch cut from 65,536 to 16,384 (the in-batch softmax's [B, B]
# logits are 17.18 GB a copy at 65,536; tables, dense gradients and both
# moments hold 74.16 GB). Batches: InteractionStream (user_id,
# user_history: Zipf(1.2) ids mod 2^20, item_id, log_q) and the other
# fields uniform in their vocabularies from default_rng(SEED)
RECSYS_BATCH, RECSYS_STEPS = 16_384, 5
RECSYS_USERS, RECSYS_ITEMS, RECSYS_HIST = 8_388_608, 1_048_576, 32
RECSYS_TAGS = 8
# (a) EmbeddingBagFunction (the kernel's forward, the plain backward)
# against autograd through the plain version on the card, at user_history's
# shape (16,384 bags of 32 Zipf ids), item_tags' (2^20 bags of 8) and bags
# holding jnp.take's out-of-range ids (-1, -V, V, V + 5): forward within
# EMB_RTOL/EMB_ATOL; the table's gradient sums a hot row's ~10^5 terms with
# atomics in another order than the plain path's sorted sum, so within
# RECSYS_GRAD_ATOL_REL of each gradient's largest entry
RECSYS_GRAD_ATOL_REL = 1e-4
# (c) step 0's loss and gradient norm against a control pass with the plain
# EmbeddingBag on the card: float32 sums in another order
RECSYS_CONTROL_RTOL = 1e-5
# (d) recsys_serve_step at serve_p99 and serve_bulk against its plain
# version on the card: dot products of unit vectors, summed in another order
RECSYS_SERVE_TOL = 1e-5

DRYRUN_WORKERS = 6  # processes for the sweep's meta traces (one core each), beside the main one
ENGINE_SEED, ENGINE_PR_REPS = 3, 20
ENGINE_CHUNK = 1 << 27  # edges a chunk where a pass over the 2^30 edges makes temporaries
F32_U = 2.0**-24

TIMED_BATCHES, TIMED_PER_BATCH = 5, 20
# published H100 peaks (NVIDIA data sheets): HBM bytes/s by part, the
# float32/int32 CUDA-core rate for the adds these kernels do, and the dense
# bf16 and TF32 tensor-core rates
HBM_BYTES_PER_S = {"PCIe": 2.0e12, "NVL": 3.9e12, "SXM": 3.35e12}
CUDA_CORE_OPS_PER_S = 67e12
BF16_TENSOR_OPS_PER_S = 989e12
TF32_TENSOR_OPS_PER_S = 495e12
# float32-exact products: the CUDA cores' FMAs, or the tensor cores on the
# 3xTF32 split (three TF32 products per float32 product, which hold 1e-5),
# whichever is faster
F32_EXACT_OPS_PER_S = max(CUDA_CORE_OPS_PER_S, TF32_TENSOR_OPS_PER_S / 3)


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


def bound_ms(n_bytes: float, n_ops: float, bw: float,
             ops_per_s: float = CUDA_CORE_OPS_PER_S) -> tuple[float, str]:
    t_bytes, t_ops = n_bytes / bw * 1e3, n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_ms(fn, warmup: int = 3, batches: int = TIMED_BATCHES, per_batch: int = TIMED_PER_BATCH) -> float:
    """Per-launch device time: CUDA events around batches of back-to-back
    launches (so host overhead overlaps the device work), median over the
    batches, after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(batches):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(per_batch):
            fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) / per_batch for a, b in pairs]))


def device_time_by_kernel(run, tries: int = 1) -> tuple[dict[str, float], float]:
    """Device time per kernel or copy name (ms) over one call of ``run``,
    from torch.profiler, and the call's wall time (s). Only device-side
    events count: a CPU op such as ``aten::copy_`` also carries the device
    time of what it launched, which is listed on its own as well. Where
    ``run`` may run again, ``tries`` > 1 profiles it again after a window
    in which the profiler saw no device event at all (it loses whole
    windows now and then: see ``device_ms_per_call``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
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
        if by_name:
            break
    return by_name, wall


def device_time_from_trace(run, tries: int = 1) -> tuple[dict[str, float], float]:
    """``device_time_by_kernel`` for runs of up to ~10^6 launches (the road
    graph's BFS, a train step): the device activity alone is traced, and
    each device event's duration summed straight from the profiler's raw
    trace, without building its tree of events, which takes minutes at that
    size. ``tries`` as ``device_time_by_kernel``'s."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        by_name: dict[str, float] = {}
        for e in prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
                continue
            by_name[e.name()] = by_name.get(e.name(), 0.0) + (e.end_ns() - e.start_ns()) / 1e6
        if by_name:
            break
    return by_name, wall


def device_ms_per_call(fn, calls: int = TIMED_PER_BATCH, tries: int = 5) -> tuple[float | None, int]:
    """Device time (ms) and kernel launches per call of ``fn``, from
    torch.profiler over ``calls`` back-to-back calls after one warm-up: the
    device's own time, free of the host's launch rate that CUDA events
    around back-to-back calls may measure instead. The profiler can miss a
    few events of a window (a later profile in a process has lost up to 3
    of 20), so each kernel counts as its mean over the events seen, times
    its launches per call rounded. It also loses whole windows (no device
    event at all: one window in 60 of a probe on the H100, and three in a
    row in the retrieval phase of a run), so a window without device events
    is profiled again, up to ``tries`` times; if every window was lost, the
    time is None (not measured). The launches per call that checks rely on
    come from ``launches_per_call``, which needs no profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        ms, launches = 0.0, 0
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA or e.is_user_annotation or e.self_device_time_total <= 0:
                continue
            per_call = max(round(e.count / calls), 1)
            ms += e.self_device_time_total / 1e3 / e.count * per_call
            launches += per_call
        if launches:
            return ms, launches
    return None, 0


# CUgraphNodeType (cuda.h): the graph nodes that run device work
GRAPH_WORK_NODES = {0: "kernel", 1: "memcpy", 2: "memset"}


def launches_per_call(fn) -> dict[str, int] | None:
    """The device work one call of ``fn`` issues, counted without the
    profiler (which has lost whole windows of device events late in this
    script): the call is captured into a CUDA graph, and the graph's nodes
    are counted by type through the driver's graph API. Returns the count
    of each type of work node ({} for none), or None where ``fn`` cannot be
    captured (a call that waits on the host)."""
    import ctypes

    fn()  # outside the capture: lazy set-up, a kernel's first load
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    try:
        with torch.cuda.graph(g):
            fn()
    except RuntimeError:
        torch.cuda.synchronize()
        return None
    cu = ctypes.CDLL("libcuda.so.1")
    graph, n = ctypes.c_void_p(g.raw_cuda_graph()), ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(graph, None, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if n.value and cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    counts: dict[str, int] = {}
    for node in nodes:
        kind = ctypes.c_int(-1)
        if cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) != 0:
            raise RuntimeError("cuGraphNodeGetType failed")
        if kind.value in GRAPH_WORK_NODES:
            counts[GRAPH_WORK_NODES[kind.value]] = counts.get(GRAPH_WORK_NODES[kind.value], 0) + 1
    g.reset()
    return counts


def short_kernel_name(name: str, width: int = 90) -> str:
    """A profiler kernel name without its namespaces and launch arguments,
    cut to ``width``: enough to tell PyTorch's elementwise functors apart."""
    for noise in ("void ", "at::native::", "(anonymous namespace)::", "std::array<char*, 1ul>",
                  "std::array<char*, 2ul>", "std::array<char*, 3ul>"):
        name = name.replace(noise, "")
    return name.split("(")[0][:width]


def device_ms_each(launch_all, launches: int, kernel: str, rounds: int = 3) -> dict:
    """Device time (ms) of each of the ``launches`` launches of the kernel
    whose name holds ``kernel`` that one call of ``launch_all`` makes, from
    torch.profiler over ``rounds`` calls after one warm-up: each launch's
    median over the rounds, then their mean and the worst. Where the
    profiler dropped events, the mean and worst of the events seen."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    launch_all()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(rounds):
            launch_all()
        torch.cuda.synchronize()
    seen = sorted((e.time_range.start, e.time_range.elapsed_us() / 1e3) for e in prof.events()
                  if e.device_type == DeviceType.CUDA and kernel in e.name)
    ms = np.array([d for _, d in seen])
    if ms.size == rounds * launches:
        ms = np.median(ms.reshape(rounds, launches), axis=0)
    return {"launches": launches, "events_seen": len(seen), "mean_ms": float(ms.mean()), "worst_ms": float(ms.max())}


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
    from repro_torch.algorithms.degree_count import PACKAGE_EDGES
    from repro_torch.kernels.degree_count import degree_count as degree_count_ops
    from repro_torch.kernels.degree_count import degree_count_cuda, degree_count_plain
    from repro_torch.kernels.degree_count.degree_count import _degree_count_path, _degree_count_variant
    from repro_torch.kernels.spmv import (
        BLOCK_EDGES, DST_TILE, build_tiles, gather_probe_cuda, spmv_rows_cuda, spmv_rows_plain, spmv_tiles,
    )
    from repro_torch.kernels.spmv import ops as spmv_ops

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
    for what, t in (("in", t_in), ("out", t_out)):
        blk = t.blocks
        n_pieces = int((blk[1, :-1] >= 0).sum())
        per_block = t.row_ptr[blk[0, 1:].long()] - t.row_ptr[blk[0, :-1].long()]
        whole = per_block[blk[1, :-1] < 0].float()
        log(f"tables {what}: {T} tiles of {DST_TILE}, {t.n_blocks} row blocks of <= {BLOCK_EDGES} edges "
            f"({n_pieces} of them pieces of {int((blk[1, :-1] == 0).sum())} long rows); whole-row blocks "
            f"hold {float(whole.mean()):.0f} edges on average, {int(whole.max())} at most")
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
    half = check_spmv(t_in, contrib, 0, T // 2, False, "in-edges first half")
    if not torch.equal(half, full[: (T // 2) * 512]):
        raise AssertionError("spmv first half differs from the full sweep")
    frontier = torch.zeros(V, dtype=torch.float32, device=dev)
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    frontier[torch.randperm(V, generator=gen)[:4096].to(dev)] = 1.0
    counts = check_spmv(t_out, frontier, 0, T, True, "out-edges BFS count sweep")
    part = check_spmv(t_out, frontier, a, b, True, "out-edges partial range")
    half = check_spmv(t_out, frontier, T // 2, T, True, "out-edges second half")
    if not (torch.equal(part, counts[a * 512 : b * 512]) and torch.equal(half, counts[(T // 2) * 512 :])):
        raise AssertionError("spmv out-edge ranges differ from the full sweep")

    ids = (torch.stack([g.src, g.dst]) % V).to(torch.int32)
    packages = [ids[:, a : a + PACKAGE_EDGES] for a in range(0, E, PACKAGE_EDGES)]
    whole = ids[0, : E // PACKAGE_EDGES * PACKAGE_EDGES].reshape(-1, PACKAGE_EDGES)
    one_id = (whole.amin(1) == whole.amax(1)).nonzero().flatten()
    if one_id.numel() == 0:
        raise AssertionError("no 16 Ki-edge package whose src row is one id")
    hub = int(one_id[0]) * PACKAGE_EDGES
    log(f"degree_count: {len(packages)} packages of {PACKAGE_EDGES} edges, {one_id.numel()} with one src id")
    dc_err = 0
    odd = E // 3 + 1
    cases = [(V, ids, 0, E), (V, ids, E // 3, E // 2), (V, ids, hub, hub + PACKAGE_EDGES),
             (V, ids, odd, odd + 3 * PACKAGE_EDGES + 5)]
    table = (torch.stack([g.src, g.dst]) % 1_000_003).to(torch.int32)
    cases += [(1_000_003, table, 0, E), (1_000_003, table, E // 3, E // 2)]
    for c, table, a, b in cases:  # the wrapper's choice, then each kernel forced
        want = degree_count_plain(table[:, a:b], torch.zeros(c, dtype=torch.int32, device=dev))
        for path in (None, *DC_PATHS):
            counts = torch.zeros(c, dtype=torch.int32, device=dev)
            got = degree_count_cuda(table[:, a:b], counts) if path is None else _degree_count_variant(
                table[:, a:b], counts, path)
            err = int((got - want).abs().max())
            dc_err = max(dc_err, err)
            if err != 0:
                raise AssertionError(f"degree_count ({path or 'dispatch'}) C={c} edges [{a}, {b}) "
                                     f"differs from plain by {err}")
        log(f"degree_count C={c} edges [{a}, {b}) ({_degree_count_path(b - a, 2)} by dispatch; "
            f"{', '.join(DC_PATHS)} forced) ok: max |kernel - plain| = 0")
    del table
    # the module's entry point over the whole graph (the private kernel, by
    # its size) against the numpy oracle
    dc_ref = alg.degree_count_reference(g.src.cpu().numpy(), g.dst.cpu().numpy(), V)
    before = dict(degree_count_cuda.launches_by_path)
    if not np.array_equal(degree_count_ops(g.src, g.dst, V).cpu().numpy(), dc_ref):
        raise AssertionError("ops.degree_count over the whole graph differs from the oracle")
    took = [k for k, n in degree_count_cuda.launches_by_path.items() if n > before[k]]
    log(f"ops.degree_count over the whole graph ({took} kernel) equals the numpy oracle")
    del pr

    # 4. main path ---------------------------------------------------------
    spmv_rows_cuda.launches = 0
    degree_count_cuda.launches = 0
    degree_count_cuda.launches_by_path = dict.fromkeys(degree_count_cuda.launches_by_path, 0)
    rep, made, wall = run_mix(core, alg, g, "cuda")
    launches = {"spmv": spmv_rows_cuda.launches, "degree_count": degree_count_cuda.launches}
    dc_by_path = dict(degree_count_cuda.launches_by_path)
    log(f"main path (cuda backend): {wall:.2f} s wall, launches {launches} (degree_count {dc_by_path}), "
        f"fused packages {rep.total_fused}, stolen {rep.total_stolen}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"main path never launched the {name} kernel")
    if dc_by_path["runs"] <= 0:  # the path's launches (<= 2 x 16 Ki ids) take the runs kernel
        raise AssertionError("main path never launched the degree-count runs kernel")
    pr_ref = alg.pagerank_reference(g, iters=PR_ITERS)
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

    # where the main path's device time goes: a second, profiled cuda run,
    # which also logs the spmv launches by size (the backend looks up
    # ops.spmv_tiles at each call)
    sizes: list[int] = []

    def counted(tables, c, t0, t1, out=None):
        sizes.append(t1 - t0)
        return spmv_tiles(tables, c, t0, t1, out)

    spmv_ops.spmv_tiles = counted
    try:
        by_name, pwall = device_time_by_kernel(lambda: run_mix(core, alg, g, "cuda"))
    finally:
        spmv_ops.spmv_tiles = spmv_tiles
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    spmv_busy = sum(v for k, v in by_name.items() if "spmv" in k)
    bins = [x for x in (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024) if x < T] + [T, T + 1]
    hist = {f"[{lo}, {hi})": int(n) for lo, hi, n in zip(bins, bins[1:], np.histogram(sizes, bins=bins)[0])}
    log(json.dumps({"main_path_profile": {
        "wall_s": pwall, "device_busy_ms": busy,
        # busy over this profiled run's wall, and over the unprofiled run's
        "device_idle_share": 1.0 - busy / (pwall * 1e3),
        "device_idle_share_of_main_wall": 1.0 - busy / (wall * 1e3),
        "spmv_device_ms": spmv_busy, "spmv_launches": len(sizes),
        "spmv_launch_tiles_histogram": hist, "spmv_launch_tiles_mean": float(np.mean(sizes)),
        "top_kernels_ms": {short_kernel_name(k): v for k, v in top},
        # the degree-count queries' device time: the kernel, and the int32
        # passes around it (the backend's torch.zeros of the counters per
        # range, the executor's _counters += counts; with any other int32
        # fill or add of the path)
        "degree_count": {
            "kernel_ms": sum(v for k, v in by_name.items() if "degree_count" in k),
            "int32_fill_ms": sum(v for k, v in by_name.items() if "FillFunctor<int>" in k),
            "int32_add_ms": sum(v for k, v in by_name.items() if "add<int>" in k),
        },
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
    # the main path's gang of 16 cuts a range into 16 launches: each slice
    # of T/16 tiles, with its own bound
    w = T // POOL
    slices = []
    for a in range(0, T, w):
        e_s = int(row_ptr[(a + w) * DST_TILE] - row_ptr[a * DST_TILE])
        slices.append({"tiles": [a, a + w], "edges": e_s,
                       "ms": time_ms(lambda: spmv_tiles(t_in, contrib, a, a + w)),
                       "bound_ms": bound_ms(e_s * 4 + (w * DST_TILE + 1) * 8 + V * 4 + w * DST_TILE * 4, e_s, bw)[0]})
    slice_ms = sorted(x["ms"] for x in slices)

    def per_launch_device_ms(ranges) -> float:
        def launch_all():
            for a, b in ranges:
                spmv_tiles(t_in, contrib, a, b)
        ms = device_ms_per_call(launch_all, calls=3)[0]
        return None if ms is None else ms / len(ranges)

    slice_dev = per_launch_device_ms([(a, a + w) for a in range(0, T, w)])
    two_dev = per_launch_device_ms([(a, a + 2) for a in range(0, T, 2)])
    probe_ms = time_ms(lambda: gather_probe_cuda(t_in.src, contrib))
    out_ms = time_ms(lambda: spmv_tiles(t_out, frontier, 0, T))
    spmv_shapes = {
        "full_in_sweep": {"tiles": T, "edges": E, "ms": k_ms, "bound_ms": b_ms},
        "slice_T_over_16": {"tiles": w, "ms_min": slice_ms[0], "ms_median": float(np.median(slice_ms)),
                            "ms_max": slice_ms[-1], "ms_sum_of_16": float(sum(slice_ms)),
                            "device_ms_per_launch": slice_dev, "slices": slices},
        "two_tile_ranges": {"launches": T // 2, "device_ms_per_launch": two_dev},
        "full_out_sweep_bfs": {"tiles": T, "edges": int(t_out.row_ptr[-1]), "ms": out_ms},
        "gather_probe_full_in": {"edges": E, "ms": probe_ms},
    }
    log(json.dumps({"spmv_times": spmv_shapes}))
    kernels = [{
        "name": "spmv", "design": "row blocks of <= BLOCK_EDGES edges, a CTA each; long rows in pieces",
        "route": "cuda", "source": "src/repro_torch/csrc/spmv.cu",
        "replaces": "src/repro/kernels/spmv/spmv.py:47",
        "launches": launches["spmv"], "max_abs_err": spmv_err,
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
        "gather_probe_ms": probe_ms, "slice_ms_median": float(np.median(slice_ms)),
        "slice_device_ms": slice_dev, "two_tile_device_ms": two_dev,
    }]
    counts = torch.zeros(V, dtype=torch.int32, device=dev)

    def launch_packages():
        for p in packages:
            degree_count_cuda(p, counts)

    per_package = device_ms_each(launch_packages, len(packages), "degree_count")
    log(json.dumps({"degree_count_package_device_ms": per_package}))
    counts.zero_()
    k_ms = time_ms(lambda: degree_count_cuda(ids, counts))
    p_ms = time_ms(lambda: degree_count_plain(ids, counts))
    flat = ids.reshape(-1)
    lib_ms = time_ms(lambda: torch.bincount(flat, minlength=V))
    b_ms, b_by = bound_ms(2 * E * 4 + V * 4, 2 * E, bw)
    kernels.append({
        "name": "degree_count", "route": "cuda", "source": "src/repro_torch/csrc/degree_count.cu",
        "replaces": "src/repro/kernels/degree_count/degree_count.py:64",
        "design": "runs of equal ids summed in a warp, one atomic per run; large launches through a "
                  "shared-memory table",
        "launches": launches["degree_count"], "launches_by_path": dc_by_path, "max_abs_err": float(dc_err),
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
        "package_device_ms_mean": per_package["mean_ms"], "package_device_ms_worst": per_package["worst_ms"],
    })
    return kernels


class Oracles:
    """The numpy oracles of one graph, each computed once: BFS levels by
    source, PageRank ranks by iteration count."""

    def __init__(self, alg, graph):
        self.alg, self.graph = alg, graph
        self.bfs: dict[int, np.ndarray] = {}
        self.pr: dict[int, np.ndarray] = {}

    def check(self, ex, what: str) -> None:
        alg = self.alg
        if isinstance(ex, alg.BFSExecutor):
            if ex.source not in self.bfs:
                self.bfs[ex.source] = alg.bfs_reference(self.graph, ex.source)
            if not np.array_equal(ex.result(), self.bfs[ex.source]):
                raise AssertionError(f"{what}: BFS from {ex.source} differs from the oracle")
            return
        if ex._iter != PR_ITERS:
            raise AssertionError(f"{what}: PageRank ran {ex._iter} iterations")
        if ex._iter not in self.pr:
            self.pr[ex._iter] = alg.pagerank_reference(self.graph, iters=ex._iter)
        np.testing.assert_allclose(ex.result(), self.pr[ex._iter], rtol=PR_RTOL, atol=PR_ATOL, err_msg=what)


def hub_sources(graph) -> np.ndarray:
    """Vertex ids by descending out-degree (benchmarks/common.py::make_executor's
    BFS sources)."""
    return np.argsort(-graph.out_degrees().cpu().numpy())


def run_real_mix(core, alg, graph, algorithm: str, backend):
    """fig12's (PageRank-pull) or fig13's (BFS) run on one data set:
    REAL_SESSIONS sessions of one query each, as
    benchmarks/common.py::run_sessions sets them (policy "scheduler",
    stealing on, the engine's default pool)."""
    hubs = hub_sources(graph)
    made = []

    def mk(s, q):
        if algorithm == "bfs":
            ex = alg.BFSExecutor(graph, int(hubs[s % 8]))
        else:
            ex = alg.PageRankExecutor(graph, mode="pull", max_iters=PR_ITERS, tol=0)
        made.append(ex)
        return ex

    eng = core.MultiQueryEngine(core.XEON_E5_2660V4, policy="scheduler")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = eng.run_sessions(mk, sessions=REAL_SESSIONS, queries_per_session=1,
                           config=core.EngineConfig(steal=True, backend=backend))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if eng.pool.available != eng.pool.capacity:
        raise AssertionError("worker grants leaked")
    return rep, made, wall


def hold_kernels_at_scale(alg, g, bw: float) -> dict:
    """spmv over the graph's full in-edge sweep against its plain version
    (and timed beside it, one PyTorch sparse product and its bound), and
    ``ops.degree_count`` of the whole graph against the numpy oracle."""
    from repro_torch.kernels.degree_count import degree_count as degree_count_ops
    from repro_torch.kernels.spmv import DST_TILE, build_tiles, spmv_rows_plain, spmv_tiles

    V, E = g.num_vertices, g.num_edges
    pr = alg.PageRankExecutor(g, mode="pull", max_iters=1, tol=0)
    pr.start()
    in_src, in_dst = pr.pull_edges()
    t_in = build_tiles(in_src, in_dst, V)
    T, contrib = t_in.n_tiles, pr.contrib
    got = spmv_tiles(t_in, contrib, 0, T).reshape(-1)[:V]
    want = spmv_rows_plain(t_in.row_ptr[: V + 1], t_in.src, contrib)
    # The same float32 terms summed in float64: exact to ~1e-16. Any order of
    # float32 additions of n nonnegative terms lies within gamma(n - 1) =
    # (n - 1)u / (1 - (n - 1)u), u = 2^-24, of their exact sum, relative; the
    # kernel and the plain version each do, so they lie within twice that of
    # each other, row by row. LiveJournal's in-rows run longer than sf20's,
    # past where the sf20 phase's flat SPMV_RTOL holds for any order.
    exact = spmv_rows_plain(t_in.row_ptr[: V + 1], t_in.src, contrib.double())
    nu = (t_in.row_ptr[1 : V + 1] - t_in.row_ptr[:V] - 1).clamp(min=0).double() * 2.0**-24
    tol = 2 * nu / (1 - nu) * exact + SPMV_ATOL
    diff = (got.double() - want.double()).abs()
    if not bool((diff <= tol).all()):
        i = int((diff - tol).argmax())
        raise AssertionError(f"spmv at {g.name}'s in-sweep: row {i} differs from the plain version by "
                             f"{float(diff[i]):.3e}, past the float32 bound {float(tol[i]):.3e}")
    err = float(diff.max())
    pos = exact > 0
    rel = {k: float(((x.double() - exact).abs()[pos] / exact[pos]).max()) for k, x in (("kernel", got), ("plain", want))}
    worst = int((diff / tol).argmax())
    k_ms = time_ms(lambda: spmv_tiles(t_in, contrib, 0, T))
    p_ms = time_ms(lambda: spmv_rows_plain(t_in.row_ptr, t_in.src, contrib))
    csr = torch.sparse_csr_tensor(
        t_in.row_ptr[: V + 1], t_in.src.to(torch.int64),
        torch.ones(E, dtype=torch.float32, device=contrib.device), size=(V, V),
    )
    col = contrib.unsqueeze(1)
    lib_ms = time_ms(lambda: csr.matmul(col))
    b_ms, b_by = bound_ms(E * 4 + t_in.row_ptr.numel() * 8 + V * 4 + T * DST_TILE * 4, E, bw)
    spmv = {"edges": E, "tiles": T, "max_abs_err": err, "max_rel_err_vs_float64": rel,
            "longest_row": int((t_in.row_ptr[1:] - t_in.row_ptr[:-1]).max()),
            "diff_over_bound_worst": float(diff[worst] / tol[worst]),
            "ms": k_ms, "plain_ms": p_ms, "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by}
    log(f"spmv at {g.name}'s full in-edge sweep ({E} edges): max |kernel - plain| = {err:.3e}, every row "
        f"within the float32 bound (worst at {spmv['diff_over_bound_worst']:.3f} of it); largest relative "
        f"error against float64 {rel}; {k_ms:.3f} ms (plain {p_ms:.3f}, sparse CSR product {lib_ms:.3f}, "
        f"bound {b_ms:.3f} by {b_by})")
    del csr, col, got, want, exact, nu, tol, diff, t_in, pr
    t0 = time.perf_counter()
    want_dc = alg.degree_count_reference(g.src.cpu().numpy(), g.dst.cpu().numpy(), V)
    oracle_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got_dc = degree_count_ops(g.src, g.dst, V)
    torch.cuda.synchronize()
    dc_s = time.perf_counter() - t0
    if not np.array_equal(got_dc.cpu().numpy(), want_dc):
        raise AssertionError(f"ops.degree_count over {g.name} differs from the numpy oracle")
    log(f"ops.degree_count over {g.name}'s {2 * E} endpoint ids equals the numpy oracle ({dc_s * 1e3:.1f} ms "
        f"wall; the oracle {oracle_s:.1f} s)")
    return {"spmv_in_sweep": spmv, "degree_count_whole_graph": {"ids": 2 * E, "max_abs_err": 0, "wall_ms": dc_s * 1e3}}


def datasets_path(dev: torch.device, bw: float) -> tuple[dict, dict]:
    """Phase 6: fig12's PageRank-pull and fig13's BFS mixes through the
    ``cuda`` backend on each SNAP surrogate at its full size. Every result
    is held against its numpy oracle, the modeled numbers against the same
    run on the ``modeled`` backend; a third, profiled run gives the device's
    busy time. Returns spmv's launches per run and the kernels' holds at
    LiveJournal's size."""
    from repro_torch import algorithms as alg
    from repro_torch import core
    from repro_torch.graph import load_dataset
    from repro_torch.kernels.spmv import spmv_rows_cuda

    launches: dict[str, int] = {}
    held: dict = {}
    for name, div in DATASETS.items():
        t0 = time.perf_counter()
        g = load_dataset(name, scale_div=div, device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        arrays = (g.csr.indptr, g.csr.indices, g.csr_in.indptr, g.csr_in.indices, g.src, g.dst)
        nbytes = sum(t.numel() * t.element_size() for t in arrays)
        log(f"dataset {name} (scale_div {div}, surrogate {g.surrogate}): V={g.num_vertices} E={g.num_edges}, "
            f"{nbytes / 1e9:.3f} GB of int32 graph arrays on the card, built in {build_s:.1f} s")
        if name == "soc-LiveJournal1":
            held = hold_kernels_at_scale(alg, g, bw)
        oracles = Oracles(alg, g)
        for mix in REAL_MIXES:
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            spmv_rows_cuda.launches = 0
            rep, made, wall = run_real_mix(core, alg, g, mix, "cuda")
            n_spmv = spmv_rows_cuda.launches
            peak = torch.cuda.max_memory_allocated()
            if n_spmv <= 0:
                raise AssertionError(f"{name}/{mix}: the run never launched the spmv kernel")
            launches[f"{name}/{mix}"] = n_spmv
            t0 = time.perf_counter()
            for ex in made:
                oracles.check(ex, f"{name}/{mix}")
            oracle_s = time.perf_counter() - t0
            mrep, _, mwall = run_real_mix(core, alg, g, mix, "modeled")
            if (rep.throughput_modeled(), rep.makespan_modeled_ns) != (
                mrep.throughput_modeled(), mrep.makespan_modeled_ns
            ):
                raise AssertionError(f"{name}/{mix}: modeled numbers differ from the modeled backend's run")
            del made, mrep
            t0 = time.perf_counter()
            by_name, pwall = device_time_from_trace(lambda: run_real_mix(core, alg, g, mix, "cuda"))
            profile_s = time.perf_counter() - t0
            busy = sum(by_name.values())
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
            log(json.dumps({"dataset_run": {
                "dataset": name, "scale_div": div, "mix": mix, "sessions": REAL_SESSIONS,
                "wall_s": wall, "edges": rep.total_edges, "measured_edges_per_s": rep.total_edges / wall,
                "throughput_modeled": rep.throughput_modeled(), "makespan_modeled_ns": rep.makespan_modeled_ns,
                "iterations": [r.iterations for r in rep.records], "modeled_backend_wall_s": mwall,
                "oracle_s": oracle_s, "max_memory_allocated_gb": peak / 1e9,
                "spmv_launches": n_spmv, "spmv_device_ms": sum(v for k, v in by_name.items() if "spmv" in k),
                "profiled_wall_s": pwall, "profile_with_processing_s": profile_s,
                "device_busy_ms": busy, "device_idle_share": 1.0 - busy / (pwall * 1e3),
                "top_kernels_ms": {short_kernel_name(k, 60): v for k, v in top},
            }}))
            del rep
        del g, oracles, arrays
        gc.collect()
        torch.cuda.empty_cache()
    return launches, held


def dynamic_path(dev: torch.device) -> dict:
    """Phase 7: fig22's live ingest at RMAT scale DYN_SCALE. The base graph
    holds the first BASE_FRACTION of the edge stream; a GraphEpochLog
    publishes the rest in N_BATCHES batches on fig22's cadence while 8
    reader sessions run its PR/BFS mix through the ``cuda`` backend, each
    reader pinned to the snapshot it started on. Every reader is held
    against its own snapshot's oracle, the modeled numbers against the same
    run on the ``modeled`` backend; the static variant (no writer) runs too.
    Returns spmv's launches in the dynamic run."""
    from repro_torch import algorithms as alg
    from repro_torch import core
    from repro_torch.graph import GraphEpochLog, build_graph, rmat_edges
    from repro_torch.kernels.spmv import spmv_rows_cuda

    class TimedLog(GraphEpochLog):
        """The epoch log, recording each publish's host seconds and the
        card's allocated memory after it."""

        def __init__(self, base):
            super().__init__(base)
            self.publish_s: list[float] = []
            self.allocated_gb: list[float] = []

        def publish(self):
            before = self.epoch
            t0 = time.perf_counter()
            g = super().publish()
            torch.cuda.synchronize()
            if g.epoch != before:
                self.publish_s.append(time.perf_counter() - t0)
                self.allocated_gb.append(torch.cuda.memory_allocated() / 1e9)
            return g

    t0 = time.perf_counter()
    src, dst = rmat_edges(DYN_SCALE, seed=DYN_SEED)
    cut = int(src.size * BASE_FRACTION)
    base = build_graph(src[:cut], dst[:cut], 1 << DYN_SCALE, name=f"sf{DYN_SCALE}_dyn", device=dev)
    parts = np.array_split(np.arange(cut, src.size), N_BATCHES)
    batches = [(src[i], dst[i]) for i in parts]
    torch.cuda.synchronize()
    log(f"dynamic: base sf{DYN_SCALE} snapshot of {base.num_edges} edges, {src.size - cut} held out in "
        f"{N_BATCHES} batches of {[len(b[0]) for b in batches]}, built in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB allocated")
    del src, dst
    hubs_by_epoch: dict[int, np.ndarray] = {}

    def run(dynamic: bool, backend, factor: float):
        elog = TimedLog(base) if dynamic else None
        stream = core.IngestStream(log=elog, batches=batches, interval_ns=INTERVAL_NS * factor) if dynamic else None
        pinned = {}

        def mk(s, q):
            g = elog.current() if dynamic else base
            kind = DYN_ALGOS[s]
            if kind == "bfs":
                if g.epoch not in hubs_by_epoch:
                    hubs_by_epoch[g.epoch] = hub_sources(g)
                ex = alg.BFSExecutor(g, int(hubs_by_epoch[g.epoch][s % 8]))
            else:
                ex = alg.PageRankExecutor(g, mode=kind.split("_")[1], max_iters=PR_ITERS, tol=0)
            pinned[(s, q)] = ex
            return ex

        eng = core.MultiQueryEngine(core.XEON_E5_2660V4, pool_capacity=DYN_POOL, policy="scheduler")
        cfg = core.EngineConfig(
            steal=True, fuse=True, arrivals=[i * ARRIVAL_GAP_NS * factor for i in range(DYN_SESSIONS)],
            dynamic=dynamic, ingest=stream, backend=backend,
        )
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = eng.run_sessions(mk, sessions=DYN_SESSIONS, queries_per_session=DYN_QUERIES, config=cfg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if eng.pool.available != eng.pool.capacity:
            raise AssertionError("worker grants leaked")
        return rep, pinned, elog, wall

    def spread(rep, final_epoch: int) -> bool:
        """fig22's check: readers on at least two epochs, one of them
        before the last publish, and one started after a publish."""
        epochs = {r.graph_epoch for r in rep.records}
        return len(epochs) >= 2 and any(e < final_epoch for e in epochs) and any(e > 0 for e in epochs)

    # readers pin their epochs by the modeled clock alone, so the modeled
    # run shows whether fig22's cadence spreads them at this scale
    factor = 1.0
    while True:
        mrep, _, mlog, mwall = run(True, "modeled", factor)
        if spread(mrep, mlog.epoch):
            break
        factor *= 4
        if factor > 4 ** 5:
            raise AssertionError("no cadence factor spreads the readers over two epochs")
    log(f"dynamic: cadence factor {factor:g} (interval {INTERVAL_NS * factor:g} ns, arrival gap "
        f"{ARRIVAL_GAP_NS * factor:g} ns); modeled backend {mwall:.1f} s wall")

    backend = core.CudaBackend()
    builds: list[dict] = []
    build_tables = backend._spmv_tables

    def timed_tables(key, *args):
        if key in backend._graph_tables:
            return build_tables(key, *args)
        t0 = time.perf_counter()
        out = build_tables(key, *args)
        torch.cuda.synchronize()
        builds.append({"epoch": key[0][1], "direction": key[1], "s": time.perf_counter() - t0})
        return out

    backend._spmv_tables = timed_tables
    torch.cuda.reset_peak_memory_stats()
    spmv_rows_cuda.launches = 0
    rep, pinned, dlog, wall = run(True, backend, factor)
    n_spmv = spmv_rows_cuda.launches
    if n_spmv <= 0:
        raise AssertionError("the dynamic run never launched the spmv kernel")
    if rep.epochs_published != N_BATCHES:
        raise AssertionError(f"{rep.epochs_published} epochs published, not {N_BATCHES}")
    for r in rep.records:
        if r.graph_epoch != pinned[(r.session, r.query)].graph.epoch:
            raise AssertionError(f"record s{r.session}q{r.query} stamped epoch {r.graph_epoch}, its "
                                 f"executor ran on epoch {pinned[(r.session, r.query)].graph.epoch}")
    if not spread(rep, dlog.epoch):
        raise AssertionError("the readers did not spread over the epochs")
    oracles: dict[int, Oracles] = {}
    t0 = time.perf_counter()
    for (s, q), ex in sorted(pinned.items()):
        e = ex.graph.epoch
        oracles.setdefault(e, Oracles(alg, ex.graph)).check(ex, f"dynamic reader s{s}q{q} on epoch {e}")
    oracle_s = time.perf_counter() - t0
    same = (
        [(r.modeled_ns, r.graph_epoch, r.edges) for r in rep.records]
        == [(r.modeled_ns, r.graph_epoch, r.edges) for r in mrep.records]
        and (rep.throughput_modeled(), rep.makespan_modeled_ns, rep.ingest_events)
        == (mrep.throughput_modeled(), mrep.makespan_modeled_ns, mrep.ingest_events)
    )
    if not same:
        raise AssertionError("the dynamic run's modeled numbers differ from the modeled backend's")
    tables = [h.tables for h in backend._graph_tables.values() if h.kind == "tables"]
    table_gb = sum(t.row_ptr.numel() * 8 + t.src.numel() * 4 + t.blocks.numel() * 4 + t.scratch.numel() * 4
                   for t in tables) / 1e9
    dynamic = {
        "scale": DYN_SCALE, "base_edges": base.num_edges, "final_edges": dlog.current().num_edges,
        "cadence_factor": factor, "wall_s": wall, "edges": rep.total_edges,
        "measured_edges_per_s": rep.total_edges / wall, "throughput_modeled": rep.throughput_modeled(),
        "makespan_modeled_ns": rep.makespan_modeled_ns, "epochs_published": rep.epochs_published,
        "reader_epochs": [[r.session, r.query, r.algorithm, r.graph_epoch] for r in rep.records],
        "publish_host_s": dlog.publish_s, "allocated_gb_after_publish": dlog.allocated_gb,
        "table_builds": builds, "table_cache_entries": len(tables), "table_cache_gb": table_gb,
        "allocated_gb_at_end": torch.cuda.memory_allocated() / 1e9,
        "max_memory_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
        "spmv_launches": n_spmv, "oracle_s": oracle_s, "modeled_backend_wall_s": mwall,
    }
    log(json.dumps({"dynamic_run": dynamic}))
    del rep, mrep, pinned, dlog, mlog, backend, tables
    gc.collect()

    srep, spinned, _, swall = run(False, "cuda", factor)
    for (s, q), ex in sorted(spinned.items()):
        oracles.setdefault(0, Oracles(alg, base)).check(ex, f"static reader s{s}q{q}")
    if any(r.graph_epoch is not None for r in srep.records) or srep.epochs_published != 0:
        raise AssertionError("the static variant stamped an epoch")
    smrep, _, _, _ = run(False, "modeled", factor)
    if (srep.throughput_modeled(), srep.makespan_modeled_ns) != (smrep.throughput_modeled(), smrep.makespan_modeled_ns):
        raise AssertionError("the static variant's modeled numbers differ from the modeled backend's")
    log(json.dumps({"dynamic_static_variant": {
        "wall_s": swall, "edges": srep.total_edges, "measured_edges_per_s": srep.total_edges / swall,
        "throughput_modeled": srep.throughput_modeled(), "makespan_modeled_ns": srep.makespan_modeled_ns,
    }}))
    return {"dynamic": n_spmv}


@torch.no_grad()
def retrieval_path(dev: torch.device, bw: float) -> list[dict]:
    """Phase 8: the two-tower retrieval server at ``make_config()``'s full
    width. Builds the 2^20-candidate corpus with the item tower, answers
    REQUESTS requests at each batch size (user tower, then ``score_topk``),
    holds every result against plain PyTorch on the card, and times both
    kernels at the shapes the server gave them."""
    from torch.nn import functional as F

    from repro_torch import core
    from repro_torch.configs import get_arch
    from repro_torch.kernels.embedding_bag import embedding_bag_cuda, embedding_bag_plain
    from repro_torch.kernels.scoring import score_topk, scoring_cuda, scoring_plain
    from repro_torch.kernels.scoring.scoring import _scoring_path
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
    scoring_cuda.launches_by_path = {"stream": 0, "tc": 0}
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
    by_path = dict(scoring_cuda.launches_by_path)
    for name, n in {**launches, **{f"scoring ({p})": n for p, n in by_path.items()}}.items():
        if n <= 0:
            raise AssertionError(f"the retrieval server never launched the {name} kernel")
    log(f"retrieval main path: corpus {N_ITEMS} x {d} in {corpus_s:.3f} s, "
        f"{sum(map(len, lat.values()))} requests, launches {launches}, scoring by path {by_path}")

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
        "launches": launches, "scoring_launches_by_path": by_path, "topk_index_swaps": swapped,
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

    # kernel times at the server's shapes, and at B = 16
    score_err, score_shapes = 0.0, []
    for b in SCORING_TIMED:
        q = answers[b, 0][0] if b in BATCHES else answers[64, 0][0][:b].contiguous()
        got, want = scoring_cuda(q, corpus), scoring_plain(q, corpus)
        torch.testing.assert_close(got, want, rtol=SCORE_RTOL, atol=SCORE_ATOL)
        err = float((got - want).abs().max())
        score_err = max(score_err, err)
        del got, want
        n_ops = 2 * b * N_ITEMS * d
        n_bytes = 4 * (b * d + N_ITEMS * d + b * N_ITEMS)
        b_ms, b_by = bound_ms(n_bytes, n_ops, bw, F32_EXACT_OPS_PER_S)
        score_shapes.append({
            "shape": f"B={b} N={N_ITEMS} D={d}", "path": _scoring_path(b, d),
            "ms": time_ms(lambda: scoring_cuda(q, corpus)),
            "plain_ms": time_ms(lambda: scoring_plain(q, corpus)),
            "library_ms": time_ms(lambda: torch.matmul(q, corpus.T)),
            "bound_ms": b_ms, "bound_by": b_by, "flop": n_ops, "bytes": n_bytes, "max_abs_err": err,
        })
        log(json.dumps({"scoring_times": score_shapes[-1]}))
    main_shape = score_shapes[-1]  # serve_p99: the most device time per request
    kernels = [{
        "name": "scoring", "design": "stream (CUDA cores) / tc (3xTF32 wgmma + TMA)", "route": "cuda",
        "source": "src/repro_torch/csrc/scoring.cu",
        "replaces": "src/repro/kernels/scoring/scoring.py:41",
        "launches": launches["scoring"], "launches_by_path": by_path, "max_abs_err": score_err,
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
        def kernel():
            return embedding_bag_cuda(table, ids, segs, w, b)

        def library():
            return F.embedding_bag(ids, table, offsets, mode="sum", per_sample_weights=w)

        # one launch a call and no other device work (the earlier two-kernel
        # version issued two), counted in a CUDA graph of one call
        k_launches, l_launches = launches_per_call(kernel), launches_per_call(library)
        if k_launches != {"kernel": 1}:
            raise AssertionError(f"an embedding_bag call issued {k_launches}, not one kernel launch")
        k_dev, k_seen = device_ms_per_call(kernel)
        l_dev, l_seen = device_ms_per_call(library)
        bag_shapes.append({
            "shape": f"{field}: {b} bags x {hot} ids, {rows} distinct rows of {table.shape[0]}",
            "ms": time_ms(kernel),
            "plain_ms": time_ms(lambda: embedding_bag_plain(table, ids, segs, w, b)),
            "library_ms": time_ms(library),
            "bound_ms": b_ms, "bound_by": b_by,
            # the profiler's device time per call beside the event times above
            "device_ms": k_dev, "library_device_ms": l_dev,
            "launches_per_call": k_launches, "library_launches_per_call": l_launches,
            "profiled_launches_per_call": k_seen, "library_profiled_launches_per_call": l_seen,
        })
        log(json.dumps({"embedding_bag_times": bag_shapes[-1]}))
    main_shape = bag_shapes[0]  # the corpus's item_tags field
    kernels.append({
        "name": "embedding_bag", "route": "cuda", "source": "src/repro_torch/csrc/embedding_bag.cu",
        "replaces": "src/repro/kernels/embedding_bag/embedding_bag.py:59",
        "launches": launches["embedding_bag"], "max_abs_err": bag_err,
        **{k: main_shape[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "at": main_shape["shape"], "shapes": bag_shapes,
    })
    return kernels


def token_agreement(tok_a: torch.Tensor, tok_p: torch.Tensor, logits_p: list, allowed) -> tuple[int, int]:
    """Greedy tokens of a path against the plain path's, ``tok_p[b, t] =
    argmax(logits_p[t][b])``. Each sequence is compared step by step while
    its history agrees; a token may differ only where the plain path's top-2
    margin is within ``allowed(b, t)``, the logit difference the two paths
    may have there (a near-tie), and the sequence is not compared past it.
    Returns (tokens equal, near-ties)."""
    equal = ties = 0
    for b in range(tok_a.shape[0]):
        for t in range(tok_a.shape[1]):
            if tok_a[b, t] == tok_p[b, t]:
                equal += 1
                continue
            top2 = torch.topk(logits_p[t][b].float(), 2).values
            margin, bound = float(top2[0] - top2[1]), allowed(b, t)
            if margin > bound:
                raise AssertionError(f"sequence {b} step {t}: tokens {int(tok_a[b, t])} != {int(tok_p[b, t])} "
                                     f"with the plain path's top-2 margin {margin:.4g} above {bound:.4g}")
            ties += 1
            break
    return equal, ties


def greedy_decode(tf, cfg, model, logits, cache, steps: int):
    """Tokens [B, steps + 1] from the prefill logits on, the logits behind
    each, and each decode step's wall seconds."""
    toks, seen, lat = [], [logits], []
    tok = logits.argmax(-1, keepdim=True).to(torch.int32)
    for _ in range(steps):
        toks.append(tok)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = tf.decode_step(cfg, model, tok, cache)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
        seen.append(logits)
        tok = logits.argmax(-1, keepdim=True).to(torch.int32)
    toks.append(tok)
    return torch.cat(toks, dim=1), seen, lat


def layer0_qkv(model, cfg, tokens: torch.Tensor):
    """Layer 0's q, k, v (after RoPE) of a prefill of ``tokens``: the flash
    kernel's inputs at the served shape."""
    from repro_torch.layers.attention import gqa_project
    from repro_torch.layers.norms import rmsnorm
    from repro_torch.layers.rotary import apply_rope

    b, s = tokens.shape
    layer = model.layers[0]
    h = rmsnorm(layer.ln1, model.embed[tokens.long()], eps=cfg.norm_eps)
    q, k, v = gqa_project(layer.attn, h)
    pos = torch.arange(s, device=tokens.device).expand(b, s)
    return apply_rope(q, pos, cfg.rope_theta), apply_rope(k, pos, cfg.rope_theta), v


def sdpa_library(q, k, v):
    """The yardstick for the flash kernel: one PyTorch call, never used by the port."""
    from torch.nn import functional as F

    return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                                          is_causal=True, enable_gqa=True).transpose(1, 2)


def hold_flash(q, k, v, what: str, bw: float, block_kv: int, reps: dict) -> dict:
    """The flash kernel against its plain version on bf16 q/k/v at
    torch.testing's bf16 tolerances (float32 q/k/v: at the JAX package's),
    then timed beside the plain version and ``scaled_dot_product_attention``,
    with its bound at the bf16 tensor-core rate (float32: the CUDA cores').
    ``reps`` overrides ``time_ms``'s counts."""
    from repro_torch.kernels.attention import flash_attention_cuda, flash_attention_plain

    def plain(q, k, v):
        return flash_attention_plain(q, k, v, block_kv=block_kv)

    b, s, h, dh = q.shape
    f32 = q.dtype == torch.float32
    name = "float32" if f32 else "bf16"
    got, want = flash_attention_cuda(q, k, v), plain(q, k, v)
    if f32:
        torch.testing.assert_close(got, want, rtol=FLASH_F32_TOL, atol=FLASH_F32_TOL)
    else:
        torch.testing.assert_close(got, want, rtol=FLASH_BF16_RTOL, atol=FLASH_BF16_ATOL)
    checks = {name: float((got.float() - want.float()).abs().max()),
              f"library_vs_plain_{name}": float((sdpa_library(q, k, v).float() - want.float()).abs().max())}
    del got, want
    log(f"flash {what} B={b} S={s} H={h} K={k.shape[2]} Dh={dh}: kernel vs plain max |diff| {checks}")
    n_ops = 2 * dh * s * (s + 1) * b * h
    n_bytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
    b_ms, b_by = bound_ms(n_bytes, n_ops, bw, CUDA_CORE_OPS_PER_S if f32 else BF16_TENSOR_OPS_PER_S)
    row = {
        "shape": f"{what}: B={b} S={s} H={h} K={k.shape[2]} Dh={dh} {name}",
        "ms": time_ms(lambda: flash_attention_cuda(q, k, v), **reps),
        "plain_ms": time_ms(lambda: plain(q, k, v), **(reps or dict(batches=5, per_batch=4))),
        "library_ms": time_ms(lambda: sdpa_library(q, k, v), **reps),
        "bound_ms": b_ms, "bound_by": b_by,
        "bound_ms_f32_cuda_cores": bound_ms(n_bytes, n_ops, bw)[0],
        "flop": n_ops, "bytes": n_bytes, "max_abs_err": checks,
    }
    log(json.dumps({"flash_attention_times": row}))
    return row


@torch.no_grad()
def lm_path(dev: torch.device, bw: float) -> list[dict]:
    """Phase 9: TinyLlama-1.1B serving at full width and depth. Batched
    prefill through the flash-attention kernel and greedy decode, the same
    prefill with the kernel's plain version, the continuous-batching engine,
    the kernel against its plain version at the served and prefill_32k
    shapes, and the times."""
    from repro_torch import core
    from repro_torch.configs import get_arch
    from repro_torch.kernels.attention import flash_attention_cuda, flash_attention_plain
    from repro_torch.launch.steps import LM_SHAPES
    from repro_torch.models import transformer as tf
    from repro_torch.serving import Request, ServingEngine

    long_seq = LM_SHAPES["prefill_32k"]["seq"]
    cfg = get_arch(LM_ARCH).make_config()
    t0 = time.perf_counter()
    model = tf.TransformerLM(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    log(f"lm: {cfg.name} {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads over "
        f"{cfg.n_kv_heads} KV heads of {cfg.dh}, d_ff {cfg.d_ff}, vocab {cfg.vocab}: {cfg.param_count()} "
        f"params, {weight_bytes / 1e9:.2f} GB on the card, built in {time.perf_counter() - t0:.1f} s")

    gen = torch.Generator(device=dev).manual_seed(SEED)
    prompts = torch.randint(0, cfg.vocab, (LM_BATCH, LM_PROMPT), generator=gen, device=dev, dtype=torch.int32)
    max_len = LM_PROMPT + LM_NEW
    rng = np.random.default_rng(SEED)
    reqs = [Request(r, rng.integers(1, cfg.vocab, size=rng.integers(ENGINE_PROMPT[0], ENGINE_PROMPT[1] + 1))
                    .astype(np.int32), max_new_tokens=ENGINE_NEW) for r in range(ENGINE_REQUESTS)]

    def plain_attention(q, k, v):
        return flash_attention_plain(q, k, v, block_kv=cfg.block_kv)

    def greedy(logits, cache, steps: int):
        return greedy_decode(tf, cfg, model, logits, cache, steps)

    # the main path: batched prefill and greedy decode, then the engine -------
    flash_attention_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = tf.prefill(cfg, model, prompts, max_len)
    torch.cuda.synchronize()
    prefill_cold_s = time.perf_counter() - t0
    prefill_launches = flash_attention_cuda.launches
    toks, seen, step_s = greedy(logits, cache, LM_NEW)
    engine = ServingEngine(cfg, model, max_batch=ENGINE_MAX_BATCH, max_len=ENGINE_MAX_LEN,
                           hw=core.XEON_E5_2660V4)
    for r in reqs:
        engine.submit(r)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    served = engine.run_until_drained()
    torch.cuda.synchronize()
    engine_s = time.perf_counter() - t0
    launches = flash_attention_cuda.launches
    if launches <= 0 or prefill_launches != cfg.n_layers:
        raise AssertionError(f"the LM path launched the flash-attention kernel {launches} times "
                             f"({prefill_launches} in the prefill of {cfg.n_layers} layers)")
    if served != ENGINE_REQUESTS * ENGINE_NEW or not all(r.done and len(r.generated) == ENGINE_NEW for r in reqs):
        raise AssertionError(f"the engine emitted {served} tokens")
    prompt_tokens = sum(len(r.prompt) for r in reqs)
    plans = {str(w): engine.plans.count(w) for w in sorted(set(engine.plans))}
    log(f"lm main path: prefill {LM_BATCH} x {LM_PROMPT} in {prefill_cold_s:.3f} s (first call), "
        f"{LM_NEW} decode steps, engine {served} tokens for {ENGINE_REQUESTS} requests "
        f"({prompt_tokens} prompt tokens replayed) in {engine_s:.3f} s, flash launches {launches}")

    # the same prefill with the kernel's plain version, and in float32 -------
    if not bool(torch.isfinite(logits.float()).all()) or logits.shape != (LM_BATCH, cfg.vocab):
        raise AssertionError("prefill logits are not finite or not [B, vocab]")
    logits_p, cache_p = tf.prefill(cfg, model, prompts, max_len, attention=plain_attention)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    model32 = tf.TransformerLM(cfg32, seed=SEED, device=dev)
    model32.load_state_dict(model.state_dict())  # the same bf16 values, held in float32
    logits32, cache32 = tf.prefill(cfg32, model32, prompts, LM_PROMPT, attention=plain_attention)
    del model32

    def deviation(a, ref):  # (RMS, largest) of a - ref
        d = a.float() - ref
        return float(d.square().mean().sqrt()), float(d.abs().max())

    logit_diff = float((logits.float() - logits_p.float()).abs().max())
    noise = {"logits": (deviation(logits, logits32), deviation(logits_p, logits32))}
    for n in ("k", "v"):
        if not torch.equal(cache[n][0, :, :LM_PROMPT], cache_p[n][0, :, :LM_PROMPT]):
            raise AssertionError(f"layer 0's {n} cache differs: it precedes any attention")
        noise[f"cache_{n}"] = (deviation(cache[n][:, :, :LM_PROMPT], cache32[n]),
                               deviation(cache_p[n][:, :, :LM_PROMPT], cache32[n]))
    del cache32
    log(f"lm kernel path vs plain path: last-position logits max |diff| {logit_diff:.4g} "
        f"(|logits| up to {float(logits_p.float().abs().max()):.3g}); (RMS, max) deviation from "
        f"float32, kernel path then plain path: {noise}")
    for what, ((rms_k, max_k), (rms_p, max_p)) in noise.items():
        if rms_k > NOISE_RMS_RATIO * rms_p or max_k > NOISE_MAX_RATIO * max_p:
            raise AssertionError(f"{what}: the kernel path strays further from float32 than the plain path")
    toks_p, seen_p, _ = greedy(logits_p, cache_p, LM_NEW)
    equal, ties = token_agreement(toks, toks_p, seen_p,
                                  lambda b, t: float((seen[t][b].float() - seen_p[t][b].float()).abs().max()))
    log(f"lm greedy tokens: {equal} of {toks.numel()} equal to the plain path's, {ties} near-ties")
    del cache_p, seen_p

    # the engine's first requests against prefill + greedy decode (plain
    # attention); a near-tie is a top-2 margin within twice the drift of two
    # bf16 paths measured above
    eng_equal = eng_ties = 0
    for r in reqs[:ENGINE_CHECKED]:
        p = torch.from_numpy(r.prompt).to(dev)[None]
        rl, rc = tf.prefill(cfg, model, p, p.shape[1] + ENGINE_NEW, attention=plain_attention)
        rt, rseen, _ = greedy(rl, rc, ENGINE_NEW - 1)
        e, t = token_agreement(torch.tensor(r.generated, device=dev)[None], rt, rseen, lambda b, t: 2 * logit_diff)
        eng_equal, eng_ties = eng_equal + e, eng_ties + t
    log(f"lm engine: {eng_equal} tokens of its first {ENGINE_CHECKED} requests equal prefill + decode's, "
        f"{eng_ties} near-ties")

    # the kernel against its plain version on layer 0's q/k/v ---------------
    long_tokens = torch.randint(0, cfg.vocab, (1, long_seq), generator=gen, device=dev, dtype=torch.int32)
    shapes = []
    for what, tokens, reps in (("served", prompts, {}), ("prefill_32k", long_tokens,
                                                        dict(warmup=1, batches=3, per_batch=1))):
        q, k, v = layer0_qkv(model, cfg, tokens)
        shapes.append(hold_flash(q, k, v, what, bw, cfg.block_kv, reps))
        if what == "served":  # float32 inputs: the CUDA-core kernel, at B=2
            shapes.append(hold_flash(q[:2].float(), k[:2].float(), v[:2].float(), "served float32", bw,
                                     cfg.block_kv, {}))
        del q, k, v
    flash_err = max(shapes[0]["max_abs_err"]["bf16"], shapes[1]["max_abs_err"]["float32"],
                    shapes[2]["max_abs_err"]["bf16"])
    torch.cuda.empty_cache()

    # end-to-end times: a warm prefill, the decode steps, and a profiled prefill
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tf.prefill(cfg, model, prompts, max_len)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    by_name, pwall = device_time_by_kernel(lambda: tf.prefill(cfg, model, prompts, max_len), tries=3)
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    flash_busy = sum(v for k_, v in by_name.items() if "flash_attention" in k_)
    if not any("flash_attention_wgmma_kernel" in k_ for k_ in by_name):
        raise AssertionError("the profiled bf16 prefill ran no tensor-core flash kernel")
    # one decode step at the same shapes (the cache is full: the step reads
    # every entry and its write is dropped, as at the reference's edge)
    step_by_name, step_wall = device_time_by_kernel(lambda: tf.decode_step(cfg, model, toks[:, -1:], cache))
    step_busy = sum(step_by_name.values())
    log(json.dumps({"lm_path": {
        "arch": cfg.name, "weight_bytes": weight_bytes,
        "prefill_batch": LM_BATCH, "prompt_len": LM_PROMPT,
        "prefill_s": prefill_s, "prefill_first_call_s": prefill_cold_s,
        "prefill_tokens_per_s": LM_BATCH * LM_PROMPT / prefill_s,
        "decode_steps": LM_NEW, "decode_step_ms_median": float(np.median(step_s)) * 1e3,
        "decode_step_ms_all": [x * 1e3 for x in step_s],
        "decode_tokens_per_s": LM_BATCH / float(np.median(step_s)),
        "engine": {"requests": ENGINE_REQUESTS, "prompt_tokens": prompt_tokens, "new_tokens": served,
                   "wall_s": engine_s, "tokens_per_s": served / engine_s,
                   "ticks": len(engine.plans), "planned_group_width_xeon_model": plans},
        "flash_launches": launches, "logit_max_abs_diff": logit_diff,
        "deviation_from_float32_kernel_then_plain": noise,
        "greedy_tokens_equal": equal, "greedy_near_ties": ties,
    }}))
    log(json.dumps({"lm_prefill_profile": {
        "wall_s": pwall, "device_busy_ms": busy, "device_idle_share": 1.0 - busy / (pwall * 1e3),
        "flash_attention_ms": flash_busy, "top_kernels_ms": {k_[:60]: v for k_, v in top},
    }}))
    log(json.dumps({"lm_decode_step_profile": {
        "wall_s": step_wall, "device_busy_ms": step_busy, "device_idle_share": 1.0 - step_busy / (step_wall * 1e3),
    }}))

    main_shape = shapes[0]
    return [{
        "name": "flash_attention", "design": "wgmma+tma, split-P", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/attention/flash_attention.py:84",
        "launches": launches, "max_abs_err": flash_err,
        **{k_: main_shape[k_] for k_ in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                         "bound_ms_f32_cuda_cores")},
        "at": main_shape["shape"], "shapes": shapes,
    }]


class RoutingRecorder:
    """Wraps the transformer's ``moe_block`` while active and records each
    call's routing: the experts each token chose (``chosen`` [T, E] bool),
    those whose (token, choice) pair the dense dispatch kept (``kept``), and
    the pairs it dropped; with ``keep_first_input`` also the first call's
    input (layer 0's ``ln2`` activations). The records come from the port's
    own ``route`` and ``dense_positions`` on the block's input; the block
    itself runs unchanged."""

    def __init__(self, tf, moe, keep_first_input: bool = False):
        self.tf, self.moe, self.keep_first_input = tf, moe, keep_first_input
        self.calls: list[dict] = []
        self.first_input = None

    def __enter__(self):
        self.orig = self.tf.moe_block
        moe = self.moe

        def recorded(params, x, cfg):
            flat = x.reshape(-1, x.shape[-1])
            if self.keep_first_input and self.first_input is None:
                self.first_input = flat.clone()
            _, _, idx = moe.route(params, flat, cfg)
            keep = moe.dense_positions(idx, cfg.num_experts) < moe._capacity(flat.shape[0], cfg)
            onehot = torch.nn.functional.one_hot(idx, cfg.num_experts).bool()
            self.calls.append({"chosen": onehot.any(1), "kept": (onehot & keep[..., None]).any(1),
                               "dropped": int((~keep).sum())})
            return self.orig(params, x, cfg)

        self.tf.moe_block = recorded
        return self

    def __exit__(self, *exc):
        self.tf.moe_block = self.orig


def moe_oracle(params, x: torch.Tensor, cfg) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The dense-dispatch MoE block from its definition, in float32, written
    apart from the port's: the router's probabilities from an IEEE float32
    product of the bf16 tokens and router weight; each token's top-k experts
    by repeated argmax (the first of equal values, as ``lax.top_k``); the
    gates renormalised; each expert keeps the first ``capacity`` (token,
    choice) pairs that chose it, in token-major order; and an expert's
    SwiGLU over its kept tokens with its weights upcast to float32 one
    expert at a time. Returns (out [T, D] float32, its terms' scale [T, D]
    (the sum of the absolute values of the terms that make each output),
    experts [T, k], gates [T, k], kept [T, k])."""
    from torch.nn import functional as F

    t, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    capacity = max(int(t * k * cfg.capacity_factor / e), 1)
    xf = x.float()
    probs = torch.softmax(xf @ params["w_router"].float(), dim=-1)
    masked, experts, vals = probs.clone(), [], []
    for _ in range(k):
        i = masked.argmax(-1, keepdim=True)
        experts.append(i)
        vals.append(probs.gather(1, i))
        masked.scatter_(1, i, float("-inf"))
    experts, vals = torch.cat(experts, 1), torch.cat(vals, 1)
    gates = vals / vals.sum(-1, keepdim=True)
    kept = torch.zeros(t, k, dtype=torch.bool, device=x.device)
    out = torch.zeros(t, d, dtype=torch.float32, device=x.device)
    scale = torch.zeros(t, d, dtype=torch.float32, device=x.device)
    flat = experts.reshape(-1)
    for ex in range(e):
        pairs = (flat == ex).nonzero()[:, 0][:capacity]
        tok, choice = pairs // k, pairs % k
        kept[tok, choice] = True
        if pairs.numel() == 0:
            continue
        wg, wu, wo = (params[n][ex].float() for n in ("wi_gate", "wi_up", "wo"))
        xe = xf[tok]
        term = ((F.silu(xe @ wg) * (xe @ wu)) @ wo) * gates[tok, choice][:, None]
        out.index_add_(0, tok, term)
        scale.index_add_(0, tok, term.abs())
        del wg, wu, wo, xe, term
    if cfg.dense_residual:
        r = params["residual"]
        term = (F.silu(xf @ r["wi_gate"].float()) * (xf @ r["wi_up"].float())) @ r["wo"].float()
        out += term
        scale += term.abs()
    return out, scale, experts, gates, kept


def gather_kept(experts: torch.Tensor, gates: torch.Tensor, groups: int, per_group: int, e: int) -> torch.Tensor:
    """[T, k]: the (token, choice) pairs the gather dispatch keeps, from its
    definition: within each of ``groups`` runs of tokens, each expert keeps
    the ``per_group`` tokens of largest positive gate, the first of equal ones."""
    t, k = experts.shape
    tg = t // groups
    kept = torch.zeros(t, k, dtype=torch.bool, device=experts.device)
    for g0 in range(0, t, tg):
        ex, ga = experts[g0:g0 + tg], gates[g0:g0 + tg]
        for j in range(e):
            tok, choice = (ex == j).nonzero(as_tuple=True)
            order = torch.sort(-ga[tok, choice], stable=True).indices[:per_group]  # tok ascending: ties to the first
            kept[g0 + tok[order], choice[order]] = True
    return kept


def moe_tolerance_ratio(got: torch.Tensor, want: torch.Tensor, scale: torch.Tensor) -> float:
    """The largest |got - want| over its allowance MOE_RTOL * scale +
    MOE_ATOL_RMS * RMS(want): at most 1 passes."""
    allow = MOE_RTOL * scale + MOE_ATOL_RMS * want.square().mean().sqrt()
    return float(((got.float() - want).abs() / allow).max())


@torch.no_grad()
def moe_serving(dev: torch.device, bw: float, arch: str, n_layers: int, steps: int, with_engine: bool) -> dict:
    """One MoE config at full width, ``n_layers`` deep: the main path
    (prefill of MOE_BATCH x MOE_PROMPT tokens through the flash kernel,
    ``steps`` greedy decode steps, for grok the engine), then checks (a) to
    (d) and the times. Returns the phase's record and the kernel's shape rows."""
    from repro_torch import core
    from repro_torch.configs import get_arch
    from repro_torch.kernels.attention import flash_attention_cuda, flash_attention_plain
    from repro_torch.layers import moe
    from repro_torch.models import transformer as tf
    from repro_torch.serving import Request, ServingEngine

    t_phase = time.perf_counter()
    full = get_arch(arch).make_config()
    cfg = dataclasses.replace(full, n_layers=n_layers)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = tf.TransformerLM(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    m = cfg.moe
    log(f"moe: {cfg.name} {cfg.n_layers} of {full.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads "
        f"over {cfg.n_kv_heads} KV heads of {cfg.dh}, d_ff {cfg.d_ff}, {m.num_experts} experts top-{m.top_k}"
        f"{' + dense residual' if m.dense_residual else ''}, vocab {cfg.vocab}: {weight_bytes / 1e9:.2f} GB on "
        f"the card, built in {build_s:.1f} s (peak {init_peak / 1e9:.2f} GB)")

    gen = torch.Generator(device=dev).manual_seed(SEED)
    prompts = torch.randint(0, cfg.vocab, (MOE_BATCH, MOE_PROMPT), generator=gen, device=dev, dtype=torch.int32)
    max_len = MOE_PROMPT + steps
    t_prefill = MOE_BATCH * MOE_PROMPT
    cap_prefill, cap_decode = moe._capacity(t_prefill, m), moe._capacity(MOE_BATCH, m)

    def plain_attention(q, k, v):
        return flash_attention_plain(q, k, v, block_kv=cfg.block_kv)

    # the main path: prefill and greedy decode (routing recorded), then the engine
    flash_attention_cuda.launches = 0
    torch.cuda.synchronize()
    with RoutingRecorder(tf, moe, keep_first_input=True) as rec:
        t0 = time.perf_counter()
        logits, cache = tf.prefill(cfg, model, prompts, max_len)
        torch.cuda.synchronize()
        prefill_cold_s = time.perf_counter() - t0
        prefill_launches = flash_attention_cuda.launches
        toks, seen, step_s = greedy_decode(tf, cfg, model, logits, cache, steps)
    engine_out = None
    if with_engine:
        rng = np.random.default_rng(SEED)
        reqs = [Request(r, rng.integers(1, cfg.vocab, size=rng.integers(ENGINE_PROMPT[0], ENGINE_PROMPT[1] + 1))
                        .astype(np.int32), max_new_tokens=ENGINE_NEW) for r in range(ENGINE_REQUESTS)]
        engine = ServingEngine(cfg, model, max_batch=ENGINE_MAX_BATCH, max_len=ENGINE_MAX_LEN,
                               hw=core.XEON_E5_2660V4)
        for r in reqs:
            engine.submit(r)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        served = engine.run_until_drained()
        torch.cuda.synchronize()
        engine_s = time.perf_counter() - t0
        if served != ENGINE_REQUESTS * ENGINE_NEW or not all(r.done and len(r.generated) == ENGINE_NEW
                                                             for r in reqs):
            raise AssertionError(f"{arch}: the engine emitted {served} tokens")
        if not all(0 <= t < cfg.vocab for r in reqs for t in r.generated):
            raise AssertionError(f"{arch}: the engine emitted a token outside the vocabulary")
        engine_out = {"requests": ENGINE_REQUESTS, "prompt_tokens": sum(len(r.prompt) for r in reqs),
                      "new_tokens": served, "wall_s": engine_s, "tokens_per_s": served / engine_s,
                      "ticks": len(engine.plans),
                      "planned_group_width_xeon_model": {str(w): engine.plans.count(w)
                                                         for w in sorted(set(engine.plans))}}
        del engine
    launches = flash_attention_cuda.launches
    # (d) the kernel ran once a layer in the prefill (and nowhere else: decode is plain torch)
    if prefill_launches != cfg.n_layers or launches != cfg.n_layers:
        raise AssertionError(f"{arch}: {prefill_launches} flash launches in the prefill of {cfg.n_layers} "
                             f"layers, {launches} on the whole path")
    if not bool(torch.isfinite(logits.float()).all()) or logits.shape != (MOE_BATCH, cfg.vocab):
        raise AssertionError(f"{arch}: prefill logits are not finite or not [B, vocab]")
    if not all(bool(torch.isfinite(x.float()).all()) for x in seen):
        raise AssertionError(f"{arch}: decode logits are not finite")
    kernel_routes = rec.calls[:cfg.n_layers]
    dropped_prefill = [c["dropped"] for c in kernel_routes]
    dropped_decode = [sum(c["dropped"] for c in rec.calls[cfg.n_layers + i::cfg.n_layers])
                      for i in range(cfg.n_layers)]
    x0 = rec.first_input
    log(f"moe {arch} main path: prefill {MOE_BATCH} x {MOE_PROMPT} in {prefill_cold_s:.3f} s (first call, "
        f"capacity {cap_prefill}), {steps} decode steps (capacity {cap_decode}), flash launches {launches}; "
        f"(token, choice) pairs dropped per layer: prefill {dropped_prefill} of {t_prefill * m.top_k}, "
        f"decode {dropped_decode} of {steps * MOE_BATCH * m.top_k}")

    # (a) moe_block against the float32 oracle at layer 0 -----------------------
    layer0 = model.layers[0].moe
    want, scale, o_experts, o_gates, o_kept = moe_oracle(layer0, x0, m)
    _, _, experts = moe.route(layer0, x0, m)
    keep = moe.dense_positions(experts, m.num_experts) < cap_prefill
    if not torch.equal(experts, o_experts) or not torch.equal(keep, o_kept):
        raise AssertionError(f"{arch}: moe routing differs from the oracle's: "
                             f"{int((experts != o_experts).any(1).sum())} tokens' experts, "
                             f"{int((keep != o_kept).any(1).sum())} tokens' kept pairs")
    got, _ = moe.moe_block(layer0, x0[None], m)
    ratio_dense = moe_tolerance_ratio(got[0], want, scale)
    m_gather = dataclasses.replace(m, dispatch="gather", dispatch_groups=MOE_GATHER_GROUPS)
    got_g, _ = moe.moe_block(layer0, x0[None], m_gather)
    per_group = min(max(cap_prefill // MOE_GATHER_GROUPS, 1), t_prefill // MOE_GATHER_GROUPS)
    g_kept = gather_kept(o_experts, o_gates, MOE_GATHER_GROUPS, per_group, m.num_experts)
    fit = o_kept.all(1) & g_kept.all(1)
    ratio_gather = moe_tolerance_ratio(got_g[0][fit], want[fit], scale[fit])
    ratio_gather_dense = moe_tolerance_ratio(got_g[0][fit], got[0][fit].float(), scale[fit])
    oracle = {"tokens": t_prefill, "capacity": cap_prefill, "pairs_dropped": int((~o_kept).sum()),
              "dense_max_diff_over_allowance": ratio_dense,
              "dense_max_abs_diff": float((got[0].float() - want).abs().max()),
              "oracle_rms": float(want.square().mean().sqrt()),
              "gather_groups": MOE_GATHER_GROUPS, "gather_capacity_per_group": per_group,
              "gather_pairs_dropped": int((~g_kept).sum()), "tokens_fit_both": int(fit.sum()),
              "gather_vs_oracle_over_allowance": ratio_gather,
              "gather_vs_dense_over_allowance": ratio_gather_dense}
    log(json.dumps({"moe_oracle": {"arch": arch, **oracle}}))
    if max(ratio_dense, ratio_gather, ratio_gather_dense) > 1 or int(fit.sum()) == 0:
        raise AssertionError(f"{arch}: moe_block strays past the bf16 allowance from the float32 oracle: {oracle}")
    del want, scale, got, got_g, x0, experts, keep, o_experts, o_gates, o_kept, g_kept, fit
    torch.cuda.empty_cache()

    # (b) the same prefill and decode through the kernel's plain version -------
    with RoutingRecorder(tf, moe) as rec_p:
        logits_p, cache_p = tf.prefill(cfg, model, prompts, max_len, attention=plain_attention)
    for n in ("k", "v"):  # layer 0's cache precedes any attention
        if not torch.equal(cache[n][0, :, :MOE_PROMPT], cache_p[n][0, :, :MOE_PROMPT]):
            raise AssertionError(f"{arch}: layer 0's {n} cache differs between the two paths")
    # a token whose routing differed in an earlier layer carries another
    # hidden state, so only a first difference is a near-tie's; a moved
    # (token, expert) membership moves its expert's capacity edge by one
    # pair at most, so kept pairs alone differ for no more tokens than that
    flips, new_flips, keep_only, xor_pairs = [], [], [], []
    alike = torch.ones(t_prefill, dtype=torch.bool, device=dev)
    for a, b in zip(kernel_routes, rec_p.calls):
        chosen_diff = (a["chosen"] != b["chosen"]).any(1)
        kept_diff = (a["kept"] != b["kept"]).any(1)
        flips.append(int(chosen_diff.sum()))
        new_flips.append(int((chosen_diff & alike).sum()))
        keep_only.append(int((kept_diff & ~chosen_diff).sum()))
        xor_pairs.append(int((a["chosen"] != b["chosen"]).sum()))
        alike &= ~(chosen_diff | kept_diff)
    last_alike = alike[torch.arange(MOE_BATCH, device=dev) * MOE_PROMPT + MOE_PROMPT - 1]
    log(f"moe {arch} kernel vs plain prefill: tokens whose experts differ per layer {flips} of {t_prefill} "
        f"({new_flips} for the first time), tokens whose kept pairs alone differ {keep_only} ({xor_pairs} "
        f"(token, expert) memberships moved)")
    for f, ko, xp in zip(new_flips, keep_only, xor_pairs):
        if f > MOE_FLIP_SHARE * t_prefill or ko > xp:
            raise AssertionError(f"{arch}: routing of the kernel path and the plain path differs past bf16 "
                                 f"near-ties: {flips}, {new_flips}, {keep_only}, {xor_pairs}")
    dl = (logits.float() - logits_p.float())[last_alike]
    rel = float(dl.square().mean().sqrt() / logits_p.float()[last_alike].square().mean().sqrt()) \
        if bool(last_alike.any()) else float("nan")
    logit_diff = float((logits.float() - logits_p.float()).abs().max())
    if bool(last_alike.any()) and not rel <= MOE_LOGIT_REL_RMS:
        raise AssertionError(f"{arch}: last-position logits differ by {rel:.4g} RMS (relative) where routing agreed")
    toks_p, seen_p, _ = greedy_decode(tf, cfg, model, logits_p, cache_p, steps)
    equal, ties = token_agreement(toks, toks_p, seen_p,
                                  lambda b, t: float((seen[t][b].float() - seen_p[t][b].float()).abs().max()))
    log(f"moe {arch}: {int(last_alike.sum())} of {MOE_BATCH} sequences' last tokens routed alike in every layer, "
        f"their logits' relative RMS difference {rel:.4g}; largest |diff| over all {logit_diff:.4g}; greedy tokens "
        f"{equal} of {toks.numel()} equal to the plain path's, {ties} near-ties")
    del cache_p, seen_p, logits_p, rec_p

    # (c) the kernel against its plain version on layer 0's q/k/v ---------------
    q, k, v = layer0_qkv(model, cfg, prompts)
    flash_row = hold_flash(q, k, v, f"{arch} served", bw, cfg.block_kv, {})
    del q, k, v
    torch.cuda.empty_cache()

    # end-to-end times: a warm prefill, a profiled prefill and decode step
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tf.prefill(cfg, model, prompts, max_len)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    by_name, pwall = device_time_by_kernel(lambda: tf.prefill(cfg, model, prompts, max_len), tries=3)
    busy = sum(by_name.values())
    if not any("flash_attention_wgmma_kernel" in k_ for k_ in by_name):
        raise AssertionError(f"{arch}: the profiled prefill ran no tensor-core flash kernel")
    step_by_name, step_wall = device_time_by_kernel(lambda: tf.decode_step(cfg, model, toks[:, -1:], cache))
    step_busy = sum(step_by_name.values())
    top = lambda d: {short_kernel_name(k_, 60): v_ for k_, v_ in sorted(d.items(), key=lambda kv: -kv[1])[:8]}  # noqa: E731
    record = {
        "arch": arch, "layers": cfg.n_layers, "layers_full": full.n_layers, "weight_bytes": weight_bytes,
        "build_s": build_s, "init_peak_bytes": init_peak,
        "prefill_batch": MOE_BATCH, "prompt_len": MOE_PROMPT, "capacity_prefill": cap_prefill,
        "capacity_decode": cap_decode,
        "prefill_s": prefill_s, "prefill_first_call_s": prefill_cold_s, "prefill_tokens_per_s": t_prefill / prefill_s,
        "decode_steps": steps, "decode_step_ms_median": float(np.median(step_s)) * 1e3,
        "decode_step_ms_all": [x * 1e3 for x in step_s], "decode_tokens_per_s": MOE_BATCH / float(np.median(step_s)),
        "engine": engine_out, "flash_launches": launches,
        "pairs_dropped_prefill_per_layer": dropped_prefill, "pairs_dropped_decode_per_layer": dropped_decode,
        "oracle_layer0": oracle,
        "kernel_vs_plain": {"tokens_experts_differ_per_layer": flips, "tokens_first_differ_per_layer": new_flips,
                            "tokens_kept_only_differ_per_layer": keep_only,
                            "last_tokens_alike": int(last_alike.sum()), "logit_rel_rms_where_alike": rel,
                            "logit_max_abs_diff": logit_diff, "greedy_tokens_equal": equal,
                            "greedy_near_ties": ties},
        "prefill_profile": {"wall_s": pwall, "device_busy_ms": busy, "device_idle_share": 1.0 - busy / (pwall * 1e3),
                            "flash_attention_ms": sum(v_ for k_, v_ in by_name.items() if "flash_attention" in k_),
                            "top_kernels_ms": top(by_name)},
        "decode_step_profile": {"wall_s": step_wall, "device_busy_ms": step_busy,
                                "device_idle_share": 1.0 - step_busy / (step_wall * 1e3),
                                "top_kernels_ms": top(step_by_name)},
        "peak_bytes": torch.cuda.max_memory_allocated(), "phase_s": time.perf_counter() - t_phase,
    }
    log(json.dumps({"moe_path": record}))
    return {"record": record, "flash_row": flash_row, "launches": launches}


def moe_path(dev: torch.device, bw: float) -> list[dict]:
    """Phase 10: grok-1 then arctic, each freed before the next."""
    out = []
    for arch, n_layers, steps, with_engine in MOE_RUNS:
        out.append(moe_serving(dev, bw, arch, n_layers, steps, with_engine))
        gc.collect()
        torch.cuda.empty_cache()
    return out


def hold_flash_gradient(dev: torch.device, shape: tuple, dtype: torch.dtype, block_kv: int) -> dict:
    """Check (a): dq, dk, dv of ``FlashAttention`` (the kernel's forward,
    the plain blocked backward) against autograd through the kernel's plain
    version, on the same inputs."""
    from repro_torch.kernels.attention import FlashAttention, flash_attention_plain

    b, s, h, kh, dh = shape
    g = torch.Generator(device=dev).manual_seed(SEED + dh)
    q = torch.randn(b, s, h, dh, device=dev, generator=g).to(dtype)
    k, v = (torch.randn(b, s, kh, dh, device=dev, generator=g).to(dtype) for _ in range(2))
    dout = torch.randn(b, s, h, dh, device=dev, generator=g).to(dtype)
    got = torch.autograd.grad(FlashAttention.apply(*(x.requires_grad_() for x in (q, k, v)), block_kv),
                              (q, k, v), dout)
    want = torch.autograd.grad(flash_attention_plain(q, k, v, block_kv=block_kv), (q, k, v), dout)
    errs = {}
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        scale = float(w.float().abs().max())
        if dtype == torch.float32:
            torch.testing.assert_close(a, w, rtol=0, atol=GRAD_F32_ATOL_REL * scale)
        else:
            torch.testing.assert_close(a.float(), w.float(), rtol=GRAD_BF16_RTOL, atol=GRAD_BF16_ATOL_REL * scale)
        errs[name] = float((a.float() - w.float()).abs().max()) / scale
    row = {"shape": f"B={b} S={s} H={h} K={kh} Dh={dh} {str(dtype).split('.')[-1]}",
           "max_abs_err_over_largest": errs}
    log(json.dumps({"flash_gradient_check": row}))
    return row


def time_flash_training(dev: torch.device, bw: float, shape: tuple, block_kv: int) -> dict:
    """The flash kernel at the trained shape ``(B, S, H, K, Dh)`` (a
    microbatch of train_4k, TinyLlama's heads) in bf16: its forward and the Function's forward + backward and
    backward alone, beside the plain version (autograd through it) and
    ``scaled_dot_product_attention`` (library, ``enable_gqa``), each with
    its bound at the bf16 tensor-core rate: the forward's two products over
    the causal half, the backward's five (FlashAttention-2's count: S
    recomputed, dV, dP, dQ, dK)."""
    from repro_torch.kernels.attention import FlashAttention, flash_attention_cuda, flash_attention_plain

    b, s, h, kh, dh = shape
    g = torch.Generator(device=dev).manual_seed(SEED)
    q = torch.randn(b, s, h, dh, device=dev, generator=g, dtype=torch.bfloat16).requires_grad_()
    k, v = (torch.randn(b, s, kh, dh, device=dev, generator=g, dtype=torch.bfloat16).requires_grad_()
            for _ in range(2))
    dout = torch.randn(b, s, h, dh, device=dev, generator=g, dtype=torch.bfloat16)
    ins = (q, k, v)
    fwd_ops = 2 * dh * s * (s + 1) * b * h
    io_bytes = 2 * (2 * q.numel() + k.numel() + v.numel())        # q, k, v in; o out
    bwd_bytes = 2 * (3 * q.numel() + 2 * (k.numel() + v.numel()))  # q, k, v, o, dO in; dq, dk, dv out
    out = FlashAttention.apply(*ins, block_kv)
    slow = dict(warmup=1, batches=3, per_batch=1)
    row = {
        "shape": f"train_4k microbatch: B={b} S={s} H={h} K={kh} Dh={dh} bf16",
        "ms": time_ms(lambda: flash_attention_cuda(q.detach(), k.detach(), v.detach())),
        "plain_ms": time_ms(lambda: flash_attention_plain(q.detach(), k.detach(), v.detach(), block_kv=block_kv),
                            batches=5, per_batch=2),
        "library_ms": time_ms(lambda: sdpa_library(q.detach(), k.detach(), v.detach())),
        "backward_ms": time_ms(lambda: torch.autograd.grad(out, ins, dout, retain_graph=True), **slow),
        "fwd_bwd_ms": time_ms(lambda: torch.autograd.grad(FlashAttention.apply(*ins, block_kv), ins, dout), **slow),
        "plain_fwd_bwd_ms": time_ms(lambda: torch.autograd.grad(
            flash_attention_plain(*ins, block_kv=block_kv), ins, dout), **slow),
        "library_fwd_bwd_ms": time_ms(lambda: torch.autograd.grad(sdpa_library(*ins), ins, dout)),
        "flop": fwd_ops, "backward_flop": 2.5 * fwd_ops,
    }
    row["bound_ms"], row["bound_by"] = bound_ms(io_bytes, fwd_ops, bw, BF16_TENSOR_OPS_PER_S)
    row["backward_bound_ms"], row["backward_bound_by"] = bound_ms(bwd_bytes, 2.5 * fwd_ops, bw, BF16_TENSOR_OPS_PER_S)
    row["fwd_bwd_bound_ms"] = row["bound_ms"] + row["backward_bound_ms"]
    del out
    log(json.dumps({"flash_training_times": row}))
    return row


def grads_of(tf, cfg, model, tokens, labels, attention=None) -> tuple[float, dict]:
    """One microbatch's loss and its gradient tree (the reference's leaves)."""
    model.zero_grad(set_to_none=True)
    loss = tf.loss_fn(cfg, model, tokens, labels, attention=attention)
    loss.backward()
    grads = tf.params_tree(model, grads=True)
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


def lm_train_path(dev: torch.device, bw: float) -> dict:
    """Phase 11: TinyLlama-1.1B training at full width and depth. Checks
    (a) the attention's gradient, (b) step 0's loss and gradients through
    the kernel path and the plain-attention path against a float32 step,
    (c) ``train_lm`` for 6 steps and a run with checkpoints stopped after 3
    and resumed, the loss falling, (d) the flash launches a step and a
    profiled step."""
    import tempfile

    from repro_torch.configs import get_arch
    from repro_torch.data import TokenStream
    from repro_torch.kernels.attention import FlashAttention, flash_attention_cuda, flash_attention_plain
    from repro_torch.launch.steps import LM_SHAPES, lm_train_step
    from repro_torch.launch.train import train_lm
    from repro_torch.models import transformer as tf
    from repro_torch._tree import tree_leaves, tree_paths
    from repro_torch.optim import OptimizerConfig

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    arch = get_arch(LM_ARCH)
    cfg = arch.make_config()
    seq = LM_SHAPES["train_4k"]["seq"]
    mb_rows = TRAIN_BATCH // cfg.microbatches
    assert arch.OPTIMIZER == "adamw" and cfg.remat and cfg.microbatches == 8

    # (a) the attention's gradient, and the kernel's training-shape times ------
    grad_checks = [hold_flash_gradient(dev, shape, dtype, cfg.block_kv)
                   for shape in GRAD_SHAPES for dtype in (torch.float32, torch.bfloat16)]
    times = time_flash_training(dev, bw, (mb_rows, seq, cfg.n_heads, cfg.n_kv_heads, cfg.dh), cfg.block_kv)
    torch.cuda.empty_cache()
    checks_s = {"a": time.perf_counter() - t_phase}

    # (b) step 0 on one microbatch: kernel path, plain path, float32 ---------
    def plain_fwd(q, k, v):
        return flash_attention_plain(q, k, v, block_kv=cfg.block_kv)

    def plain_attention(q, k, v):  # the plain forward, the same backward
        return FlashAttention.apply(q, k, v, cfg.block_kv, plain_fwd)

    batch = next(TokenStream(cfg.vocab, TRAIN_BATCH, seq, seed=0))
    tokens = torch.from_numpy(batch["tokens"][:mb_rows]).to(dev)
    labels = torch.from_numpy(batch["labels"][:mb_rows]).to(dev)
    model = tf.TransformerLM(cfg, seed=SEED, device=dev, masters=True)
    flash_attention_cuda.launches = 0
    loss_k, g_kernel = grads_of(tf, cfg, model, tokens, labels)
    if flash_attention_cuda.launches != 2 * cfg.n_layers:
        raise AssertionError(f"one microbatch launched the kernel {flash_attention_cuda.launches} times")
    loss_p, g_plain = grads_of(tf, cfg, model, tokens, labels, plain_attention)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    loss_32, g_32 = grads_of(tf, cfg32, model, tokens, labels, plain_fwd)  # autograd through the plain version
    del model
    names = [name for name, _ in tree_paths(g_32)]
    noise = {}
    for name, gk, gp, g32 in zip(names, tree_leaves(g_kernel), tree_leaves(g_plain), tree_leaves(g_32)):
        dk, dp = gk.float() - g32, gp.float() - g32
        noise[name] = {"kernel": (float(dk.square().mean().sqrt()), float(dk.abs().max())),
                       "plain": (float(dp.square().mean().sqrt()), float(dp.abs().max())),
                       "rms_float32": float(g32.square().mean().sqrt())}
    del g_kernel, g_plain, g_32
    checks_s["b"] = time.perf_counter() - t_phase - checks_s["a"]
    log(json.dumps({"lm_train_step0": {"loss_kernel": loss_k, "loss_plain": loss_p, "loss_float32": loss_32,
                                       "grad_deviation_from_float32": noise}}))
    for what, loss in (("kernel", loss_k), ("plain", loss_p)):
        if not abs(loss - loss_32) <= TRAIN_LOSS_RTOL * abs(loss_32):
            raise AssertionError(f"step 0's loss through the {what} path {loss} is not within a bf16 step of {loss_32}")
    for name, d in noise.items():
        (rms_k, max_k), (rms_p, max_p) = d["kernel"], d["plain"]
        if rms_k > NOISE_RMS_RATIO * rms_p or max_k > NOISE_MAX_RATIO * max_p:
            raise AssertionError(f"the gradient of {name}: the kernel path strays further from float32 "
                                 "than the plain path")
    torch.cuda.empty_cache()

    # (c) + (d) the main path: train_lm for 6 steps, then a run with a
    # checkpoint every 3 that stops after 3 and resumes (the uninterrupted
    # run writes no checkpoint: nothing reads one) -----------------------------
    kw = dict(steps=TRAIN_STEPS, batch=TRAIN_BATCH, seq=seq, ckpt_every=TRAIN_CKPT_EVERY, log_every=1, device=dev)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_") as tmp:
        flash_attention_cuda.launches = 0
        t0 = time.perf_counter()
        full = train_lm(cfg, **kw)
        full_s = time.perf_counter() - t0
        launches = flash_attention_cuda.launches
        per_step = launches / TRAIN_STEPS
        if per_step != 2 * cfg.n_layers * cfg.microbatches:
            raise AssertionError(f"{launches} flash launches in {TRAIN_STEPS} steps, "
                                 f"not {2 * cfg.n_layers * cfg.microbatches} a step")
        losses = dict(full["losses"])
        if not all(np.isfinite(list(losses.values()))) or not losses[TRAIN_STEPS - 1] < losses[0]:
            raise AssertionError(f"the loss did not fall: {losses}")
        want, step_s, tokens_per_s = full["params"], full["step_s"], full["tokens_per_s"]
        del full
        gc.collect()
        t0 = time.perf_counter()
        train_lm(cfg, ckpt_dir=f"{tmp}/cut", stop_after=TRAIN_CKPT_EVERY, **kw)
        gc.collect()
        resumed = train_lm(cfg, ckpt_dir=f"{tmp}/cut", resume=True, **kw)
        resume_s = time.perf_counter() - t0
        got_losses = dict(resumed["losses"])
        loss_diff = max(abs(got_losses[s_] - losses[s_]) / abs(losses[s_]) for s_ in got_losses)
        param_diff = max(float((a - b).abs().max()) for a, b in zip(tree_leaves(resumed["params"]), tree_leaves(want)))
        log(f"lm training resume: losses at steps {sorted(got_losses)} within {loss_diff:.3g} relative, "
            f"largest weight difference {param_diff:.3g} (allowed {RESUME_LOSS_RTOL}, {RESUME_PARAM_ATOL})")
        if sorted(got_losses) != list(range(TRAIN_CKPT_EVERY, TRAIN_STEPS)) or loss_diff > RESUME_LOSS_RTOL \
                or param_diff > RESUME_PARAM_ATOL:
            raise AssertionError("the resumed run does not reproduce the uninterrupted one")
        del want

        # one more step, profiled: the device's share and the largest kernels
        model, opt_state = resumed["model"], resumed["opt_state"]
        del resumed
        opt_cfg = OptimizerConfig(lr=3e-4, warmup_steps=min(20, TRAIN_STEPS // 5 + 1), decay_steps=TRAIN_STEPS)
        step = lm_train_step(cfg, opt_cfg)
        nxt = next(TokenStream(cfg.vocab, TRAIN_BATCH, seq, seed=0, step=TRAIN_STEPS))
        nxt = {k_: torch.from_numpy(v_).to(dev) for k_, v_ in nxt.items()}
        # the profiler loses a whole window now and then: a lost one is a step
        # again; a step's ~10^5 launches are summed from the raw trace
        t0 = time.perf_counter()
        by_name, pwall = device_time_from_trace(lambda: step(model, opt_state, nxt), tries=3)
        profile_s = time.perf_counter() - t0
    busy = sum(by_name.values())
    flash_busy = sum(v_ for k_, v_ in by_name.items() if "flash_attention" in k_)
    if not any("flash_attention_wgmma_kernel" in k_ for k_ in by_name):
        raise AssertionError("the profiled train step ran no tensor-core flash kernel")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:16]
    record = {
        "arch": cfg.name, "params": cfg.param_count(), "batch": TRAIN_BATCH, "seq": seq,
        "microbatches": cfg.microbatches, "remat": cfg.remat, "optimizer": arch.OPTIMIZER,
        "reduced": {"batch": "256 -> 16 (train_4k's; two sequences a microbatch)"},
        "gradient_checks": grad_checks,
        "step0": {"loss_kernel": loss_k, "loss_plain": loss_p, "loss_float32": loss_32},
        "losses": losses, "resumed_losses": got_losses,
        "resume_max_loss_rel_diff": loss_diff, "resume_max_param_diff": param_diff,
        "flash_launches": launches, "flash_launches_per_step": per_step,
        "checks_a_s": checks_s["a"], "checks_b_s": checks_s["b"],
        "train_lm_s": full_s, "stop_and_resume_s": resume_s,
        "step_s_all": step_s, "step_s_median": float(np.median(step_s)),
        "tokens_per_s_median_step": TRAIN_BATCH * seq / float(np.median(step_s)),
        "train_lm_tokens_per_s": tokens_per_s,
        "profiled_step": {"wall_s": pwall, "with_processing_s": profile_s,
                          "device_busy_ms": busy, "device_idle_share": 1.0 - busy / (pwall * 1e3),
                          "flash_attention_ms": flash_busy,
                          "top_kernels_ms": {short_kernel_name(k_, 70): v_ for k_, v_ in top}},
        "peak_bytes": torch.cuda.max_memory_allocated(), "phase_s": time.perf_counter() - t_phase,
    }
    log(json.dumps({"lm_train_path": record}))
    return {"record": record, "times": times, "launches_per_step": per_step}


def hold_flash_small(dev: torch.device, bw: float, dtype: torch.dtype) -> dict:
    """``hold_flash`` at the smoke configs' head dim (``SMALL_DH_SHAPE``,
    their ``block_kv`` for the plain version) in ``dtype``, and the device
    work one call issues, which must be one kernel."""
    from repro_torch.kernels.attention import flash_attention_cuda

    b, s, h, kh, dh = SMALL_DH_SHAPE
    g = torch.Generator(device=dev).manual_seed(SEED + dh)
    q = torch.randn(b, s, h, dh, device=dev, generator=g).to(dtype)
    k, v = (torch.randn(b, s, kh, dh, device=dev, generator=g).to(dtype) for _ in range(2))
    row = hold_flash(q, k, v, "smoke head dim", bw, SMALL_DH_BLOCK_KV, {})
    row["launches_per_call"] = launches_per_call(lambda: flash_attention_cuda(q, k, v))
    if row["launches_per_call"] != {"kernel": 1}:
        raise AssertionError(f"flash at Dh={dh} {dtype}: one call issued {row['launches_per_call']}, not one kernel")
    return row


def small_head_dims_path(dev: torch.device, bw: float) -> dict:
    """Phase 12: the flash kernel at the LM smoke configs' head dim (16) on
    both of its paths, then each smoke config's prefill and one train step
    on the card against the CPU, then the trainer with its defaults."""
    from repro_torch._tree import tree_leaves
    from repro_torch.configs import get_arch
    from repro_torch.kernels.attention import flash_attention_cuda
    from repro_torch.launch import train
    from repro_torch.launch.steps import lm_train_step
    from repro_torch.models import transformer as tf
    from repro_torch.optim import OptimizerConfig, adamw_init

    shapes = [hold_flash_small(dev, bw, torch.bfloat16), hold_flash_small(dev, bw, torch.float32)]
    torch.cuda.empty_cache()

    rng = np.random.default_rng(SEED)
    opt = OptimizerConfig(lr=1e-3, warmup_steps=0, decay_steps=10, eps=1e-4)
    cases, t0 = [], time.perf_counter()
    # the main path: each smoke config's prefill and train step, then the trainer
    flash_attention_cuda.launches = 0
    for arch, dispatch in SMALL_DH_CASES:
        cfg = get_arch(arch).make_smoke_config()
        over = {"microbatches": 2, "remat": True}
        if dispatch is not None:
            over["moe"] = dataclasses.replace(cfg.moe, dispatch=dispatch)
        cfg = dataclasses.replace(cfg, **over)
        if cfg.dh != 16:
            raise AssertionError(f"{arch}: smoke head dim {cfg.dh}, not 16")
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, SMALL_DH_PROMPT)).astype(np.int32))
        cpu = tf.TransformerLM(cfg, seed=SEED, device="cpu")
        card = tf.TransformerLM(cfg, seed=SEED + 1, device=dev)
        card.load_state_dict(cpu.state_dict())
        before = flash_attention_cuda.launches
        logits, cache = tf.prefill(cfg, card, toks.to(dev), SMALL_DH_PROMPT + 1)
        torch.cuda.synchronize()
        prefill_launches = flash_attention_cuda.launches - before
        want, want_cache = tf.prefill(cfg, cpu, toks, SMALL_DH_PROMPT + 1)
        torch.testing.assert_close(logits.cpu(), want, rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(cache["k"].cpu(), want_cache["k"], rtol=1e-4, atol=1e-5)
        torch.testing.assert_close(cache["v"].cpu(), want_cache["v"], rtol=1e-4, atol=1e-5)
        prefill_err = float((logits.cpu() - want).abs().max())
        del card, cpu, logits, cache

        seq = rng.integers(0, cfg.vocab, (4, SMALL_DH_TRAIN_SEQ + 1)).astype(np.int32)
        batch = {"tokens": torch.from_numpy(seq[:, :-1]), "labels": torch.from_numpy(seq[:, 1:].copy())}
        cpu = tf.TransformerLM(cfg, seed=SEED, device="cpu", masters=True)
        card = tf.TransformerLM(cfg, seed=SEED + 1, device=dev, masters=True)
        card.load_state_dict(cpu.state_dict())
        before = flash_attention_cuda.launches
        card, _, m = lm_train_step(cfg, opt)(card, adamw_init(tf.params_tree(card)),
                                             {k_: v_.to(dev) for k_, v_ in batch.items()})
        torch.cuda.synchronize()
        step_launches = flash_attention_cuda.launches - before
        cpu, _, want_m = lm_train_step(cfg, opt)(cpu, adamw_init(tf.params_tree(cpu)), batch)
        torch.testing.assert_close(m["loss"].cpu(), want_m["loss"], rtol=1e-5, atol=0)
        torch.testing.assert_close(m["gnorm"].cpu(), want_m["gnorm"], rtol=1e-4, atol=0)
        weight_err = 0.0
        for a, b in zip(tree_leaves(tf.params_tree(card)), tree_leaves(tf.params_tree(cpu))):
            torch.testing.assert_close(a.detach().cpu(), b.detach(), rtol=0, atol=1e-6)
            weight_err = max(weight_err, float((a.detach().cpu() - b.detach()).abs().max()))
        if prefill_launches != cfg.n_layers or step_launches != 2 * cfg.n_layers * cfg.microbatches:
            raise AssertionError(f"{arch} {dispatch}: {prefill_launches} prefill and {step_launches} train-step "
                                 "flash launches")
        cases.append({"arch": arch, "dispatch": dispatch, "prefill_launches": prefill_launches,
                      "train_step_launches": step_launches, "prefill_logit_max_abs_diff": prefill_err,
                      "loss": float(m["loss"]), "loss_cpu": float(want_m["loss"]),
                      "gnorm": float(m["gnorm"]), "gnorm_cpu": float(want_m["gnorm"]),
                      "weight_max_abs_diff": weight_err})
        log(json.dumps({"smoke_config_on_card": cases[-1]}))
        del card, cpu
    cases_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    before = flash_attention_cuda.launches
    with contextlib.redirect_stdout(sys.stderr):  # the trainer's step lines
        out = train.main([])
    torch.cuda.synchronize()
    trainer_launches = flash_attention_cuda.launches - before
    launches = flash_attention_cuda.launches
    cfg = train.build_small_lm("tinyllama-1.1b")
    first, last = out["losses"][0][1], out["losses"][-1][1]
    steps = len(out["step_s"])
    if not last < first:
        raise AssertionError(f"trainer defaults: loss {first} -> {last} did not fall")
    if trainer_launches != steps * cfg.n_layers or next(out["model"].parameters()).device.type != "cuda":
        raise AssertionError(f"trainer defaults: {trainer_launches} flash launches over {steps} steps on "
                             f"{next(out['model'].parameters()).device}")
    trainer = {"steps": steps, "loss_first": first, "loss_last": last, "losses": out["losses"],
               "flash_launches": trainer_launches, "wall_s": time.perf_counter() - t0,
               "step_ms_median": float(np.median(out["step_s"])) * 1e3, "tokens_per_s": out["tokens_per_s"]}
    log(json.dumps({"trainer_defaults_on_card": trainer, "smoke_cases_s": cases_s}))
    return {"shapes": shapes, "launches": launches, "cases": cases, "trainer": trainer}


# ---------------------------------------------------------------------------
# Phase 13: the GNN family
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def tf32_products():
    """float32 products on the tensor cores in TF32 (10-bit mantissas) for
    the block: phase 13's control, a forward of lower precision that each
    precision check must refuse."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def gnn_smoke_on_card(dev) -> list[dict]:
    """13(a): each smoke config's forward and one AdamW step on the card
    against the CPU (GraphCast also owner-blocked, P = 4)."""
    from _torch_gnn import CARD_CASES, card_equals_cpu

    rng = np.random.default_rng(SEED)
    cases = []
    for arch, blocked in CARD_CASES:
        cases.append(card_equals_cpu(arch, blocked, dev, rng, seed=SEED))
        log(json.dumps({"gnn_smoke_on_card": cases[-1]}))
    return cases


def gnn_example_loop(dev) -> dict:
    """13(b): examples/gnn_train.py's loop on the card, its first steps
    against the same loop on the CPU."""
    from repro_torch.data import GraphBatchStream
    from repro_torch.graph import rmat_graph
    from repro_torch.launch.steps import gnn_train_step
    from repro_torch.models.gnn import meshgraphnet as mgn
    from repro_torch.models.gnn.common import params_tree
    from repro_torch.optim import OptimizerConfig, adamw_init

    cfg = mgn.MGNConfig(n_layers=4, d_hidden=64, d_node_in=16, d_edge_in=8, d_out=3)
    opt = OptimizerConfig(name="adamw", lr=1e-3, warmup_steps=5, decay_steps=100)
    step = gnn_train_step(mgn, cfg, opt, n_graphs=1)  # clip_norm 1.0, the example's

    def run(device, steps: int, state: dict | None) -> tuple[list[float], list[float], dict]:
        model = mgn.MeshGraphNet(cfg, seed=0, device=device)
        if state is not None:
            model.load_state_dict(state)
        init = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
        opt_state = adamw_init(params_tree(model))
        stream = GraphBatchStream(rmat_graph(11, seed=1, device=device), batch_nodes=32, fanouts=(6, 4),
                                  d_feat=16, device=device)
        losses, secs = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            raw = next(stream)
            n, e = raw["nodes"].shape[0], raw["src"].shape[0]
            batch = dict(nodes=raw["feats"], src=raw["src"], dst=raw["dst"],
                         edge_feat=torch.ones(e, 8, device=raw["feats"].device),
                         node_mask=raw["node_mask"], edge_mask=raw["edge_mask"],
                         graph_ids=torch.zeros(n, dtype=torch.int32, device=raw["feats"].device),
                         targets=raw["feats"][:, :3] * 0.5)
            model, opt_state, m = step(model, opt_state, batch)
            losses.append(float(m["loss"]))
            secs.append(time.perf_counter() - t0)
        return losses, secs, init

    losses, secs, init = run(dev, GNN_LOOP_STEPS, None)
    want, _, _ = run("cpu", GNN_LOOP_CPU_STEPS, init)
    with tf32_products():  # the control: the same first steps with TF32 products
        control, _, _ = run(dev, GNN_LOOP_CPU_STEPS, init)
    rel = float(np.max(np.abs(np.array(losses[:len(want)]) / np.array(want) - 1)))
    rel_control = float(np.max(np.abs(np.array(control) / np.array(want) - 1)))
    if not rel <= GNN_LOOP_RTOL < rel_control:
        raise AssertionError(f"the example's first {len(want)} losses on the card are {rel} from the CPU's, the TF32 "
                             f"control's {rel_control}: want the first within {GNN_LOOP_RTOL}, the control past it")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"the example's loop did not fall: {losses[0]} -> {losses[-1]}")
    record = {"steps": GNN_LOOP_STEPS, "loss_first": losses[0], "loss_last": losses[-1],
              "losses_every_10": losses[::10], "cpu_losses": want, "first_steps_max_rel_diff": rel,
              "tf32_control_losses": control, "tf32_control_max_rel_diff": rel_control,
              "step_ms_median": float(np.median(secs)) * 1e3, "wall_s": float(np.sum(secs))}
    log(json.dumps({"gnn_example_loop": record}))
    return record


def gnn_full_batches(dev) -> dict:
    """13(c)'s inputs on the card, as numpy from the seed: minibatch_lg's
    nodes, edges and features (shared by MeshGraphNet, PNA and GraphCast)
    and molecule's atoms (SchNet), each laid out as gnn_abstract_batch."""
    from _torch_gnn import to_torch
    from repro_torch.graph import rmat_edges
    from repro_torch.launch.steps import GNN_SHAPES, pad_to

    rng = np.random.default_rng(SEED)
    sh = GNN_SHAPES["minibatch_lg"]
    n_real, e_real = sh["n_nodes"], sh["n_edges"]
    n, e = pad_to(n_real), pad_to(e_real)
    src_all, dst_all = rmat_edges(GNN_RMAT_SCALE, seed=SEED)
    src, dst = np.zeros(e, np.int32), np.zeros(e, np.int32)
    src[:e_real], dst[:e_real] = src_all[:e_real] % n_real, dst_all[:e_real] % n_real
    feats = rng.standard_normal((n, sh["d_feat"]), dtype=np.float32)
    feats[n_real:] = 0
    edge_feat = rng.standard_normal((e, 8), dtype=np.float32)
    edge_feat[e_real:] = 0
    lg = dict(nodes=feats, src=src, dst=dst, edge_feat=edge_feat, node_mask=np.arange(n) < n_real,
              edge_mask=np.arange(e) < e_real, graph_ids=np.zeros(n, np.int32))
    in_deg = np.bincount(dst[:e_real], minlength=n_real)

    sh = GNN_SHAPES["molecule"]
    n_real, e_real, g = sh["n_nodes"], sh["n_edges"], sh["n_graphs"]
    n, e = pad_to(n_real), pad_to(e_real)
    per, a = e_real // g, GNN_MOLECULE_ATOMS
    step = rng.normal(size=(g, a, 3))
    step *= GNN_BOND / np.linalg.norm(step, axis=-1, keepdims=True)
    pos = np.zeros((n, 3), np.float32)
    pos[:n_real] = np.cumsum(step, axis=1).reshape(-1, 3)  # a chain of atoms GNN_BOND apart
    i = rng.integers(0, a, (g, per))
    j = (i + rng.integers(1, a, (g, per))) % a
    base = (np.arange(g) * a)[:, None]
    nodes = np.zeros((n, sh["d_feat"]), np.float32)
    nodes[:n_real, 0] = rng.integers(1, 10, n_real)  # column 0: the atom type
    nodes[:n_real, 1:] = rng.standard_normal((n_real, sh["d_feat"] - 1), dtype=np.float32)
    src, dst = np.zeros(e, np.int32), np.zeros(e, np.int32)
    src[:e_real], dst[:e_real] = (base + i).reshape(-1), (base + j).reshape(-1)
    graph_ids = np.zeros(n, np.int32)
    graph_ids[:n_real] = np.arange(n_real) // a
    mol = dict(nodes=nodes, src=src, dst=dst, edge_feat=np.zeros((e, 1), np.float32),
               node_mask=np.arange(n) < n_real, edge_mask=np.arange(e) < e_real, graph_ids=graph_ids,
               positions=pos, targets=rng.normal(size=g).astype(np.float32))
    return {"minibatch_lg": to_torch(lg, dev), "molecule": to_torch(mol, dev),
            "src_all": src_all, "in_degree_zero_share": float((in_deg == 0).mean()),
            "in_degree_max": int(in_deg.max())}


def gnn_train_cell(dev, arch: str, cfg, batch: dict, n_graphs: int, mp_layers: int, n_edges: int,
                   *, blocked: bool = False, steps: int = GNN_STEPS, f64: bool = True) -> dict:
    """``steps`` AdamW steps of ``gnn_train_step`` (the configs'
    OptimizerConfig) from a seeded model: step 0's loss against a float64
    copy's forward (and, as the control that shows this check can see a
    loss of precision, the float32 forward with TF32 products), the losses
    finite and falling, the step times, edges/s, the peak memory and one
    profiled step."""
    from _torch_gnn import port_model, port_module
    from repro_torch.launch.steps import gnn_train_step
    from repro_torch.models.gnn.common import params_tree
    from repro_torch.optim import OptimizerConfig, adamw_init

    mod = port_module(arch)
    loss_fn = mod.loss_fn_blocked if blocked else mod.loss_fn
    model = port_model(arch, cfg, device=dev, seed=SEED)
    loss64 = loss_tf32 = None
    if f64:
        cfg64 = dataclasses.replace(cfg, dtype=torch.float64)
        with torch.no_grad():
            m64 = port_model(arch, cfg64, model.state_dict(), device=dev, seed=SEED)
            loss64 = float(loss_fn(cfg64, m64, dict(batch, n_graphs=n_graphs)))
            del m64
            with tf32_products():
                loss_tf32 = float(loss_fn(cfg, model, dict(batch, n_graphs=n_graphs)))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    opt_cfg = OptimizerConfig(name="adamw")
    opt_state = adamw_init(params_tree(model))
    step = gnn_train_step(mod, cfg, opt_cfg, n_graphs=n_graphs, blocked=blocked)
    losses, gnorms, secs = [], [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, opt_state, m = step(model, opt_state, batch)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        gnorms.append(float(m["gnorm"]))
    peak = torch.cuda.max_memory_allocated()
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        raise AssertionError(f"{arch}{' blocked' if blocked else ''}: losses {losses} not finite and falling")
    if loss64 is not None and not abs(losses[0] - loss64) <= GNN_F64_RTOL * abs(loss64):
        raise AssertionError(f"{arch}: step 0's loss {losses[0]} is not within {GNN_F64_RTOL} of float64's {loss64}")
    if loss64 is not None and not abs(loss_tf32 - loss64) > GNN_F64_RTOL * abs(loss64):
        raise AssertionError(f"{arch}: the TF32 control's loss {loss_tf32} is within {GNN_F64_RTOL} of float64's "
                             f"{loss64} (step 0's {losses[0]}): the check cannot see a loss of precision")
    by_name, pwall = device_time_from_trace(lambda: step(model, opt_state, batch), tries=3)
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    med = float(np.median(secs[1:]))
    record = {"arch": arch, "blocked": blocked, "layers": mp_layers, "edges": n_edges,
              "nodes": int(batch["nodes"].shape[0]), "params": sum(p.numel() for p in model.parameters()),
              "losses": losses, "gnorms": gnorms, "loss_float64": loss64,
              "step0_rel_diff_float64": None if loss64 is None else abs(losses[0] - loss64) / abs(loss64),
              "loss_tf32_control": loss_tf32,
              "tf32_control_rel_diff_float64": None if loss64 is None else abs(loss_tf32 - loss64) / abs(loss64),
              "step_ms_all": [x * 1e3 for x in secs], "step_ms_median": med * 1e3,
              "edges_per_s": n_edges * mp_layers / med, "peak_gb": peak / 1e9,
              "profiled_step": {"wall_ms": pwall * 1e3, "device_busy_ms": busy,
                                "device_idle_share": 1.0 - busy / (pwall * 1e3),
                                "top_kernels_ms": {short_kernel_name(k_, 70): v_ for k_, v_ in top}}}
    log(json.dumps({"gnn_full_width": record}))
    del model, opt_state
    return record


def gnn_blocked_full(dev, cfg, lg: dict, src_all: np.ndarray) -> dict:
    """GraphCast's owner-blocked path at minibatch_lg with P = GNN_BLOCKS:
    E / P edges a block, each block's dst inside its owner's rows; the
    blocked loss against the flat forward's on the same edges, then
    GNN_BLOCKED_STEPS training steps."""
    from _torch_gnn import port_model, to_torch
    from repro_torch.launch.steps import GNN_SHAPES, pad_to
    from repro_torch.models.gnn import graphcast

    sh = GNN_SHAPES["minibatch_lg"]
    n, e_real = lg["nodes"].shape[0], sh["n_edges"]
    p = GNN_BLOCKS
    npb, per = n // p, e_real // p
    epb = pad_to(-(-pad_to(e_real) // p), 128)
    if per * p != e_real or npb * p != n:
        raise AssertionError(f"minibatch_lg does not split into {p} even blocks")
    rng = np.random.default_rng(SEED + 1)
    mask = np.zeros((p, epb), bool)
    mask[:, :per] = True
    src = np.zeros((p, epb), np.int32)
    src[:, :per] = (src_all[:e_real] % n).reshape(p, per)
    dstl = np.zeros((p, epb), np.int32)
    dstl[:, :per] = rng.integers(0, npb, (p, per))
    ef = np.zeros((p, epb, cfg.d_edge_in), np.float32)
    ef[:, :per] = lg["edge_feat"][:e_real, :cfg.d_edge_in].cpu().numpy().reshape(p, per, -1)
    blocked = dict(lg, **to_torch(dict(src=src, dst_local=dstl, edge_feat=ef, edge_mask=mask), dev))
    blocked.pop("dst")
    flat = dict(lg, **to_torch(dict(
        src=src[:, :per].reshape(-1), dst=(dstl[:, :per] + np.arange(p)[:, None] * npb).reshape(-1).astype(np.int32),
        edge_feat=ef[:, :per].reshape(-1, cfg.d_edge_in), edge_mask=np.ones(e_real, bool)), dev))
    model = port_model("graphcast", cfg, device=dev, seed=SEED)
    with torch.no_grad():
        loss_b = float(graphcast.loss_fn_blocked(cfg, model, dict(blocked, n_graphs=1)))
        loss_f = float(graphcast.loss_fn(cfg, model, dict(flat, n_graphs=1)))
    del model, flat
    log(json.dumps({"gnn_graphcast_blocked_vs_flat": {"blocks": p, "edges_per_block": per, "slots_per_block": epb,
                                                       "loss_blocked": loss_b, "loss_flat": loss_f}}))
    if not abs(loss_b - loss_f) <= 1e-5 * abs(loss_f):
        raise AssertionError(f"graphcast: the blocked loss {loss_b} is not the flat forward's {loss_f}")
    record = gnn_train_cell(dev, "graphcast", cfg, blocked, 1, cfg.n_layers + 2, e_real, blocked=True,
                            steps=GNN_BLOCKED_STEPS, f64=False)
    record.update(blocks=p, edges_per_block=per, slots_per_block=epb, loss_blocked=loss_b, loss_flat=loss_f)
    return record


def gnn_path(dev: torch.device) -> dict:
    """Phase 13: the GNN family. (a) the smoke configs on the card against
    the CPU; (b) examples/gnn_train.py's loop; (c) each config's
    make_config at its reference shape, trained 5 steps (GraphCast also
    owner-blocked at P = 512). None of the five kernels runs on this path
    (message passing is index_add/scatter_reduce, as the reference's
    segment_sum lies outside any pallas_call): each wrapper's count stays 0."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels.attention import flash_attention_cuda
    from repro_torch.kernels.degree_count import degree_count_cuda
    from repro_torch.kernels.embedding_bag import embedding_bag_cuda
    from repro_torch.kernels.scoring import scoring_cuda
    from repro_torch.kernels.spmv import spmv_rows_cuda
    from repro_torch.launch.steps import GNN_SHAPES

    wrappers = {"spmv": spmv_rows_cuda, "degree_count": degree_count_cuda, "scoring": scoring_cuda,
                "embedding_bag": embedding_bag_cuda, "flash_attention": flash_attention_cuda}
    for w in wrappers.values():
        w.launches = 0
    t_phase = time.perf_counter()
    smoke = gnn_smoke_on_card(dev)
    t_a = time.perf_counter() - t_phase
    loop = gnn_example_loop(dev)
    t_b = time.perf_counter() - t_phase - t_a

    data = gnn_full_batches(dev)
    lg, mol = data["minibatch_lg"], data["molecule"]
    log(json.dumps({"gnn_inputs": {"minibatch_lg_in_degree_zero_share": data["in_degree_zero_share"],
                                   "minibatch_lg_in_degree_max": data["in_degree_max"]}}))
    feats = lg["nodes"]
    full = []
    for arch in GNN_ARCHS:
        shape = GNN_FULL[arch]
        cfg = get_arch(arch).make_config(shape)
        n_graphs = GNN_SHAPES[shape]["n_graphs"]
        if arch == "schnet":
            batch, layers = mol, cfg.n_interactions
        else:  # edge features: the reference cells' d_edge (PNA reads none: 1)
            batch = dict(lg, edge_feat=lg["edge_feat"][:, :getattr(cfg, "d_edge_in", 1)])
            if arch == "meshgraphnet":
                batch["targets"], layers = feats[:, :cfg.d_out] * 0.5, cfg.n_layers
            elif arch == "pna":
                batch["targets"], layers = feats[:, :cfg.n_classes].argmax(-1).to(torch.int32), cfg.n_layers
            else:
                batch["targets"], layers = feats * 0.5, cfg.n_layers + 2
        n_edges = int(batch["edge_mask"].sum())
        full.append(gnn_train_cell(dev, arch, cfg, batch, n_graphs, layers, n_edges))
        full[-1]["shape"] = shape
        del batch
        gc.collect()
        torch.cuda.empty_cache()
        if arch == "graphcast":
            lg["targets"] = feats * 0.5
            full.append(gnn_blocked_full(dev, cfg, lg, data["src_all"]))
            full[-1]["shape"] = shape
            del lg["targets"]
            gc.collect()
            torch.cuda.empty_cache()
    launches = {name: w.launches for name, w in wrappers.items()}
    if any(launches.values()):
        raise AssertionError(f"the GNN phase launched kernels of other paths: {launches}")
    record = {"smoke": smoke, "example_loop": loop, "full_width": full,
              "kernel_launches": launches, "checks_a_s": t_a, "checks_b_s": t_b,
              "phase_s": time.perf_counter() - t_phase}
    log(json.dumps({"gnn_path": {k: v for k, v in record.items() if k not in ("smoke", "full_width")}}))
    return record


@contextlib.contextmanager
def plain_embedding_bag():
    """The EmbeddingBag's plain version in place of the kernel on the card
    for the block (the forward of ``ops.embedding_bag`` and of
    ``EmbeddingBagFunction``; the backward is plain either way): phase 14's
    control and serve comparison."""
    from repro_torch.kernels.embedding_bag import embedding_bag_plain, ops

    forward = ops._forward
    ops._forward = embedding_bag_plain
    try:
        yield
    finally:
        ops._forward = forward


def recsys_features(cfg, b: int, rng: np.random.Generator, dev, step: int = 0) -> dict:
    """A two-tower batch of ``b`` on the card: InteractionStream's user_id,
    user_history, item_id and log_q at step ``step`` (seed SEED), the other
    fields uniform in their vocabularies from ``rng``."""
    from repro_torch.data import InteractionStream

    stream = InteractionStream(n_users=RECSYS_USERS, n_items=RECSYS_ITEMS, batch=b, hist_len=RECSYS_HIST,
                               seed=SEED, step=step)
    raw = next(stream)
    vocab = {f.name: f.vocab for f in (*cfg.user_fields, *cfg.item_fields)}
    raw["user"]["user_geo"] = rng.integers(0, vocab["user_geo"], (b, 1)).astype(np.int32)
    raw["item"]["item_category"] = rng.integers(0, vocab["item_category"], (b, 1)).astype(np.int32)
    raw["item"]["item_tags"] = rng.integers(0, vocab["item_tags"], (b, RECSYS_TAGS)).astype(np.int32)
    for f in (*cfg.user_fields, *cfg.item_fields):
        side = raw["user"] if f in cfg.user_fields else raw["item"]
        if side[f.name].shape != (b, f.multi_hot):
            raise AssertionError(f"{f.name}: the batch holds {side[f.name].shape}, the config {(b, f.multi_hot)}")
    return {"user": {k: torch.from_numpy(v).to(dev) for k, v in raw["user"].items()},
            "item": {k: torch.from_numpy(v).to(dev) for k, v in raw["item"].items()},
            "log_q": torch.from_numpy(raw["log_q"]).to(dev)}


def hold_bag_function(dev, name: str, v: int, bags: int, ids: torch.Tensor) -> dict:
    """14(a): EmbeddingBagFunction on the card (weights requiring grad)
    against autograd through the plain version, forward and both gradients,
    one kernel launch a forward; the backward's device ms and launches
    (profiler) and the forward + backward's CUDA-event ms beside the plain
    path's."""
    from repro_torch.kernels.embedding_bag import EmbeddingBagFunction, embedding_bag_cuda, embedding_bag_plain

    d = 256
    gen = torch.Generator(device=dev).manual_seed(SEED)
    table = (torch.randn(v, d, device=dev, generator=gen) * 0.01).requires_grad_()
    hot = ids.numel() // bags
    segs = torch.arange(bags, dtype=torch.int32, device=dev).repeat_interleave(hot)
    w = torch.rand(ids.numel(), device=dev, generator=gen).requires_grad_()
    cot = torch.randn(bags, d, device=dev, generator=gen)

    def run(fn):
        table.grad = w.grad = None
        out = fn(table, ids, segs, w, bags)
        out.backward(cot)
        return out.detach(), table.grad, w.grad

    def kernel(*a):
        return EmbeddingBagFunction.apply(*a)

    before = embedding_bag_cuda.launches
    got = run(kernel)
    torch.cuda.synchronize()
    if embedding_bag_cuda.launches != before + 1:
        raise AssertionError(f"{name}: a Function forward launched {embedding_bag_cuda.launches - before} kernels")
    want = run(embedding_bag_plain)
    if embedding_bag_cuda.launches != before + 1:
        raise AssertionError(f"{name}: the plain path launched the kernel")
    errs = []
    for part, a, b in zip(("forward", "table_grad", "weights_grad"), got, want):
        finite = ~b.isnan()
        atol = EMB_ATOL if part == "forward" else RECSYS_GRAD_ATOL_REL * float(b[finite].abs().max())
        torch.testing.assert_close(a, b, rtol=EMB_RTOL, atol=atol, equal_nan=True, msg=lambda m: f"{name} {part}: {m}")
        errs.append(float((a - b)[finite].abs().max()))
    nan_bags = int(got[0].isnan().any(-1).sum())
    del got, want
    out = kernel(table, ids, segs, w, bags)

    def backward():
        table.grad = w.grad = None
        out.backward(cot, retain_graph=True)

    bwd_ms, bwd_launches = device_ms_per_call(backward, calls=3)
    record = {"case": name, "bags": bags, "ids_per_bag": hot, "rows": v,
              "distinct_rows": int(torch.unique(ids).numel()), "nan_bags": nan_bags,
              "max_abs_err": dict(zip(("forward", "table_grad", "weights_grad"), errs)),
              "backward_device_ms": bwd_ms, "backward_launches": bwd_launches,
              "kernel_fwd_bwd_ms": time_ms(lambda: run(kernel), warmup=1, batches=3, per_batch=2),
              "plain_fwd_bwd_ms": time_ms(lambda: run(embedding_bag_plain), warmup=1, batches=3, per_batch=2)}
    del out
    log(json.dumps({"recsys_bag_function": record}))
    return record


def recsys_profiled_step(model, cfg, opt, opt_state, batch) -> dict:
    """One step of ``recsys_train_step``'s body (the same public calls in
    the same order), CUDA events between its parts, under the profiler:
    device ms by kernel name, each part's event ms, busy and idle."""
    from repro_torch.models import recsys as tt
    from repro_torch.optim import adamw_update_, clip_by_global_norm_

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    state = {}

    def step():
        model.zero_grad(set_to_none=True)
        ev[0].record()
        loss = tt.loss_fn(cfg, model, batch)
        ev[1].record()
        loss.backward()
        ev[2].record()
        grads = tt.params_tree(model, grads=True)
        clip_by_global_norm_(grads, opt.clip_norm)
        ev[3].record()
        state["opt"] = adamw_update_(opt, grads, opt_state, tt.params_tree(model))
        ev[4].record()
        del grads
        model.zero_grad(set_to_none=True)

    by_name, wall = device_time_from_trace(step, tries=3)
    busy = sum(by_name.values())
    parts = dict(zip(("forward", "backward", "clip", "adamw"), (ev[i].elapsed_time(ev[i + 1]) for i in range(4))))

    def share(*keys):
        return sum(x for k, x in by_name.items() if any(key in k for key in keys))

    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:14]
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy, "device_idle_share": 1.0 - busy / (wall * 1e3),
            "part_event_ms": parts,
            "kernel_groups_ms": {"embedding_bag_kernel (forward)": share("embedding_bag_kernel"),
                                 "index_add (backward)": share("index_add", "indexFunc"),
                                 "fill (zero-fills: the dense gradients)": share("FillFunctor"),
                                 "norm (squares and sums)": share("pow_tensor_scalar", "reduce_kernel"),
                                 "gemm": share("gemm", "sgemm", "Kernel2", "cutlass")},
            "kernels": len(by_name), "top_kernels_ms": {short_kernel_name(k, 70): x for k, x in top},
            "opt_step": int(state["opt"]["step"])}


def recsys_train_path(dev: torch.device) -> dict:
    """Phase 14: two-tower training. (a) EmbeddingBagFunction on the card
    against autograd through the plain version at user_history's and
    item_tags' shapes and on jnp.take's out-of-range ids; (b) the smoke
    config's recsys_train_step on the card against the CPU; (d)
    recsys_serve_step at make_config()'s full width at serve_p99 and
    serve_bulk against its plain version; (c) RECSYS_STEPS AdamW steps at
    full width, batch RECSYS_BATCH: step 0 against a control pass with the
    plain EmbeddingBag, the losses, step ms, examples/s, peak, launches a
    step and a profiled step."""
    from _torch_recsys import card_equals_cpu
    from repro_torch.configs import get_arch
    from repro_torch.kernels.attention import flash_attention_cuda
    from repro_torch.kernels.degree_count import degree_count_cuda
    from repro_torch.kernels.embedding_bag import embedding_bag_cuda
    from repro_torch.kernels.scoring import scoring_cuda
    from repro_torch.kernels.spmv import spmv_rows_cuda
    from repro_torch.launch.steps import RECSYS_SHAPES, recsys_serve_step, recsys_train_step
    from repro_torch.models import recsys as tt
    from repro_torch.optim import adamw_init, clip_by_global_norm_

    t_phase = time.perf_counter()
    arch = get_arch("two-tower-retrieval")
    cfg, opt = arch.make_config(), arch.OPTIMIZER
    vocab = {f.name: f.vocab for f in (*cfg.user_fields, *cfg.item_fields)}

    # (a) the Function against plain autograd ------------------------------
    rng = np.random.default_rng(SEED)
    v_hist, v_tags = vocab["user_history"], vocab["item_tags"]
    hist = torch.from_numpy((rng.zipf(1.2, RECSYS_BATCH * RECSYS_HIST) % RECSYS_ITEMS).astype(np.int32)).to(dev)
    tags = torch.from_numpy(rng.integers(0, v_tags, N_ITEMS * RECSYS_TAGS).astype(np.int32)).to(dev)
    rule = rng.integers(0, v_tags, 4096 * RECSYS_TAGS)
    rule[::3], rule[1::5], rule[2::97], rule[3::101] = -1, -v_tags, v_tags, v_tags + 5  # ~1 bag in 6 NaN
    rule = torch.from_numpy(rule.astype(np.int32)).to(dev)
    functions = [hold_bag_function(dev, "user_history", v_hist, RECSYS_BATCH, hist),
                 hold_bag_function(dev, "item_tags", v_tags, N_ITEMS, tags),
                 hold_bag_function(dev, "id_rule", v_tags, 4096, rule)]
    if [f["nan_bags"] > 0 for f in functions] != [False, False, True]:
        raise AssertionError(f"NaN bags {[f['nan_bags'] for f in functions]}: want them from the out-of-range ids only")
    del hist, tags, rule
    gc.collect()
    torch.cuda.empty_cache()
    t_a = time.perf_counter() - t_phase

    # (b) the smoke config on the card against the CPU ---------------------
    smoke = card_equals_cpu(dev, np.random.default_rng(SEED), steps=3)
    log(json.dumps({"recsys_smoke_on_card": smoke}))
    t_b = time.perf_counter() - t_phase - t_a

    # the model at full width, the batches --------------------------------
    t0 = time.perf_counter()
    model = tt.TwoTower(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    table_bytes = sum(p.numel() * p.element_size() for p in (*model.user_tables.values(),
                                                              *model.item_tables.values()))
    built_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED)
    batches = [recsys_features(cfg, RECSYS_BATCH, rng, dev, step=i) for i in range(RECSYS_STEPS + 1)]
    hot = batches[0]["user"]["user_history"].reshape(-1)
    hot_share = float(torch.bincount(hot.long()).max()) / hot.numel()

    # (d) the serve step at full width, before the optimizer state ---------
    serve = recsys_serve_step(cfg)
    serve_rows = []
    for shape in ("serve_p99", "serve_bulk"):
        b = RECSYS_SHAPES[shape]["batch"]
        feats = recsys_features(cfg, b, np.random.default_rng(SEED + 1), dev, step=100)
        embedding_bag_cuda.launches = 0
        got = serve(model, feats["user"], feats["item"])
        torch.cuda.synchronize()
        launches = embedding_bag_cuda.launches
        with plain_embedding_bag():
            want = serve(model, feats["user"], feats["item"])
            if embedding_bag_cuda.launches != launches:
                raise AssertionError("the plain serve step launched the kernel")
            plain_ms = time_ms(lambda: serve(model, feats["user"], feats["item"]), warmup=1, batches=3, per_batch=2)
        if launches != len(cfg.user_fields) + len(cfg.item_fields) or got.shape != (b,):
            raise AssertionError(f"{shape}: {launches} launches, output {tuple(got.shape)}")
        torch.testing.assert_close(got, want, rtol=RECSYS_SERVE_TOL, atol=RECSYS_SERVE_TOL)
        serve_rows.append({"shape": shape, "batch": b, "launches": launches,
                           "max_abs_err": float((got - want).abs().max()),
                           "ms": time_ms(lambda: serve(model, feats["user"], feats["item"]), warmup=1, batches=3,
                                         per_batch=4 if b < 10_000 else 2),
                           "plain_ms": plain_ms})
        log(json.dumps({"recsys_serve_step": serve_rows[-1]}))
        del feats, got, want
        gc.collect()
        torch.cuda.empty_cache()

    # (c) step 0's control with the plain EmbeddingBag, then the main path --
    with plain_embedding_bag():
        model.zero_grad(set_to_none=True)
        loss = tt.loss_fn(cfg, model, batches[0])
        loss.backward()
        control_loss = float(loss.detach())
        control_gnorm = float(clip_by_global_norm_(tt.params_tree(model, grads=True), opt.clip_norm))
        del loss
        model.zero_grad(set_to_none=True)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    opt_state = adamw_init(tt.params_tree(model))
    step = recsys_train_step(cfg, opt)
    wrappers = {"spmv": spmv_rows_cuda, "degree_count": degree_count_cuda, "scoring": scoring_cuda,
                "embedding_bag": embedding_bag_cuda, "flash_attention": flash_attention_cuda}
    for w in wrappers.values():
        w.launches = 0
    losses, gnorms, secs = [], [], []
    for i in range(RECSYS_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model, opt_state, m = step(model, opt_state, batches[i])
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["gnorm"]))
    launches = {name: w.launches for name, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    fields = len(cfg.user_fields) + len(cfg.item_fields)
    if launches["embedding_bag"] != fields * RECSYS_STEPS or any(n for k, n in launches.items()
                                                               if k != "embedding_bag"):
        raise AssertionError(f"the training steps launched {launches}: want {fields} EmbeddingBag kernels a step")
    if not np.isfinite(losses).all() or not np.isfinite(gnorms).all():
        raise AssertionError(f"losses {losses}, gradient norms {gnorms}: not finite")
    for what, got, want in (("loss", losses[0], control_loss), ("gnorm", gnorms[0], control_gnorm)):
        if not abs(got - want) <= RECSYS_CONTROL_RTOL * abs(want):
            raise AssertionError(f"step 0's {what} {got} is not within {RECSYS_CONTROL_RTOL} of the plain control's {want}")
    if int(opt_state["step"]) != RECSYS_STEPS:
        raise AssertionError(f"the optimizer counted {int(opt_state['step'])} steps")
    profile = recsys_profiled_step(model, cfg, opt, opt_state, batches[RECSYS_STEPS])
    med = float(np.median(secs[1:]))
    record = {
        "config": "make_config()", "table_bytes": table_bytes, "model_built_s": built_s,
        "batch": RECSYS_BATCH, "steps": RECSYS_STEPS, "losses": losses, "gnorms": gnorms,
        "control_loss": control_loss, "control_gnorm": control_gnorm,
        "step0_rel_diff": {"loss": abs(losses[0] - control_loss) / abs(control_loss),
                           "gnorm": abs(gnorms[0] - control_gnorm) / abs(control_gnorm)},
        "step_ms_all": [x * 1e3 for x in secs], "step_ms_median": med * 1e3,
        "examples_per_s": RECSYS_BATCH / med, "peak_gb": peak / 1e9,
        "history_hot_row_share": hot_share, "launches": launches,
        "embedding_bag_launches_per_step": launches["embedding_bag"] / RECSYS_STEPS,
        "profiled_step": profile,
    }
    log(json.dumps({"recsys_train_full_width": record}))
    del model, opt_state, batches, step
    gc.collect()
    torch.cuda.empty_cache()
    return {"functions": functions, "smoke": smoke, "serve": serve_rows, "full_width": record,
            "launches_main_path": launches["embedding_bag"],
            "checks_a_s": t_a, "checks_b_s": t_b, "phase_s": time.perf_counter() - t_phase}

def dryrun_cell(arch: str, shape: str) -> dict:
    """Phase 15 (a)'s worker (a process of its own): ``run_cell`` of the
    port's dry-run on the single-pod plan with the trip analysis, the trips
    scaled to the full depth. Where the scaled FLOPs miss the full depth's,
    also the trips at the cell's own microbatch count (the reference's
    trips run one), which the check reads."""
    torch.set_num_threads(1)
    from repro_torch.configs import get_arch
    from repro_torch.launch.dryrun import full_depth, run_cell, scaled_totals
    from repro_torch.launch.mesh import make_production_mesh

    t0 = time.perf_counter()
    rec = run_cell(arch, shape, "single", analysis=True)
    if "trip1" in rec:
        n = full_depth(arch, shape)
        rec["scaled"], rec["n_layers_full"] = scaled_totals(rec, n), n
        if rec["scaled"]["flop_counter_flops_scaled"] != rec["full"]["flop_counter_flops"]:
            mod, mesh = get_arch(arch), make_production_mesh()
            own = {f"trip{k}": {"flop_counter_flops": mod.make_cell(shape, n_layers_override=k).lower(mesh).flops}
                   for k in (1, 2)}
            rec["own_microbatches_flops_scaled"] = scaled_totals(own, n)["flop_counter_flops_scaled"]
    rec["wall_s"] = time.perf_counter() - t0
    return rec


def check_dryrun(records: list[dict]) -> list[str]:
    """Every LM and GNN cell has its trips, and its full depth's FLOPs equal
    the trips' extrapolation; or, where they do not, it is a train cell of
    an MoE config with more than one microbatch, whose extrapolation from
    trips at its own microbatch count is exact (the dense dispatch costs
    the square of a microbatch's tokens: one microbatch of them all costs
    more). Returns those cells."""
    from repro_torch.configs import get_arch

    trips = [r for r in records if get_arch(r["arch"]).FAMILY in ("lm", "gnn")]
    if len(trips) != 36 or any("trip1" not in r for r in trips):
        raise AssertionError(f"dry-run: {len(trips)} LM/GNN cells, trips in {sum('trip1' in r for r in trips)}")
    apart = []
    for r in trips:
        full, scaled = r["full"]["flop_counter_flops"], r["scaled"]["flop_counter_flops_scaled"]
        if full == scaled:
            continue
        cfg = get_arch(r["arch"]).make_config()
        moe_microbatched = r["kind"] == "train" and getattr(cfg, "moe", None) is not None and cfg.microbatches > 1
        if not (moe_microbatched and scaled > full and r.get("own_microbatches_flops_scaled") == full):
            raise AssertionError(f"dry-run {r['cell']}: full-depth FLOPs {full} vs trip-scaled {scaled} "
                                 f"(own microbatches: {r.get('own_microbatches_flops_scaled')})")
        apart.append(r["cell"])
    return apart


def rmat_on_card(scale: int, edge_factor: int, seed: int, dev) -> tuple[torch.Tensor, torch.Tensor]:
    """Graph500's RMAT recipe (``graph/rmat.py``'s A, B, C: one random draw
    and one bit of each endpoint a level, then a random vertex permutation)
    drawn on the card from a seeded ``torch.Generator``, as int32 edge
    arrays; numpy's ``rmat_edges`` would build int64 arrays of 8 GiB on the
    host at scale 26."""
    from repro_torch.graph.rmat import A, B, C

    gen = torch.Generator(device=dev).manual_seed(seed)
    v, e = 1 << scale, (1 << scale) * edge_factor
    src = torch.zeros(e, dtype=torch.int32, device=dev)
    dst = torch.zeros(e, dtype=torch.int32, device=dev)
    ab, abc = A + B, A + B + C
    for c0 in range(0, e, ENGINE_CHUNK):
        s, d = src[c0 : c0 + ENGINE_CHUNK], dst[c0 : c0 + ENGINE_CHUNK]
        for bit in range(scale):
            r = torch.rand(s.shape[0], generator=gen, device=dev)
            s |= (r >= ab).to(torch.int32) << bit                         # quadrants C and D
            d |= (((r >= A) & (r < ab)) | (r >= abc)).to(torch.int32) << bit  # B and D
    perm = torch.randperm(v, generator=gen, device=dev).to(torch.int32)
    for c0 in range(0, e, ENGINE_CHUNK):
        for t in (src, dst):
            t[c0 : c0 + ENGINE_CHUNK] = perm.index_select(0, t[c0 : c0 + ENGINE_CHUNK])
    return src, dst


def pr_bound(exact: torch.Tensor, acc64: torch.Tensor, in_deg: torch.Tensor) -> torch.Tensor:
    """The float32 error bound of ``0.15/V + 0.85 * sum`` over a row of n
    nonnegative float32 terms, in any order of additions: gamma(n - 1) of
    the exact sum for the additions (gamma(k) = k u / (1 - k u), u = 2^-24),
    times 0.85, and a few u of the result for the product, the sum with the
    constant and the constants' own roundings."""
    n = (in_deg.double() - 1).clamp_min(0)
    return 0.85 * (n * F32_U / (1 - n * F32_U)) * acc64 + 5 * F32_U * exact


def graph_engine_at_scale(dev, bw: float, step_pr, step_bfs, v: int, e: int) -> dict:
    """Phase 15 (b): the paper's own cells at V and E on the card (see the
    module docstring)."""
    from repro_torch.kernels.attention import flash_attention_cuda
    from repro_torch.kernels.degree_count import degree_count_cuda
    from repro_torch.kernels.degree_count.ops import count_into
    from repro_torch.kernels.embedding_bag import embedding_bag_cuda
    from repro_torch.kernels.scoring import scoring_cuda
    from repro_torch.kernels.spmv import spmv_rows_cuda
    from repro_torch.kernels.spmv.ops import build_tiles, spmv

    wrappers = {"spmv": spmv_rows_cuda, "degree_count": degree_count_cuda, "scoring": scoring_cuda,
                "embedding_bag": embedding_bag_cuda, "flash_attention": flash_attention_cuda}
    step_launches = dict.fromkeys(wrappers, 0)                  # the cells' steps: each must stay 0
    check_launches = dict.fromkeys(("spmv", "degree_count"), 0)  # the checks' kernels

    @contextlib.contextmanager
    def counting(into: dict):
        """Every count zeroed just before the block, read just after it."""
        for w in wrappers.values():
            w.launches = 0
        yield
        for name in into:
            into[name] += wrappers[name].launches

    scale, edge_factor = v.bit_length() - 1, e // v
    if (1 << scale, v * edge_factor) != (v, e):
        raise AssertionError(f"graph engine: V = {v}, E = {e} is not an RMAT size")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    src, dst = rmat_on_card(scale, edge_factor, ENGINE_SEED, dev)
    torch.cuda.synchronize()
    rmat_s = time.perf_counter() - t_phase

    # out-degrees through the degree_count kernel, held to bincount
    with counting(check_launches):
        out_deg = count_into(src, torch.zeros(v, dtype=torch.int32, device=dev))
    if not torch.equal(out_deg, torch.bincount(src, minlength=v).to(torch.int32)):
        raise AssertionError("graph engine: degree_count's out-degrees differ from torch.bincount")
    in_deg = torch.bincount(dst, minlength=v)

    # one PageRank-pull iteration through the cell's step, timed
    gen = torch.Generator(device=dev).manual_seed(ENGINE_SEED)
    rank = torch.rand(v, generator=gen, device=dev)
    rank /= rank.sum()
    with counting(step_launches):
        pr = step_pr(src, dst, rank, out_deg)
        ms = []
        for _ in range(ENGINE_PR_REPS):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            again = step_pr(src, dst, rank, out_deg)
            b.record()
            torch.cuda.synchronize()
            ms.append(a.elapsed_time(b))
            del again
        # where a step's device time goes
        by_kernel, _ = device_time_by_kernel(lambda: step_pr(src, dst, rank, out_deg), tries=3)
    pr_ms = float(np.median(ms))
    pr_kernels = {short_kernel_name(k): v for k, v in sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]}

    # the same terms summed in float64 (exact to ~1e-16), chunk by chunk
    contrib = torch.where(out_deg > 0, rank / torch.clamp_min(out_deg, 1), 0.0)
    c64 = contrib.double()
    acc64 = torch.zeros(v, dtype=torch.float64, device=dev)
    for c0 in range(0, e, ENGINE_CHUNK):
        acc64.index_add_(0, dst[c0 : c0 + ENGINE_CHUNK], c64.index_select(0, src[c0 : c0 + ENGINE_CHUNK]))
    del c64
    exact = 0.15 / v + 0.85 * acc64
    bound = pr_bound(exact, acc64, in_deg)

    # the spmv kernel over the same edges: the main path's PR-pull aggregation
    t0 = time.perf_counter()
    tiles = build_tiles(src, dst, v)
    torch.cuda.synchronize()
    tiles_s = time.perf_counter() - t0
    with counting(check_launches):
        via_spmv = 0.15 / v + 0.85 * spmv(tiles, contrib)
    errs = {}
    for name, got in (("pr_step", pr), ("spmv", via_spmv)):
        diff = (got.double() - exact).abs()
        if not bool((diff <= bound).all()):
            worst = int((diff - bound).argmax())
            raise AssertionError(f"graph engine: {name} row {worst} off by {float(diff[worst])} "
                                 f"(bound {float(bound[worst])}, in-degree {int(in_deg[worst])})")
        errs[name] = float((diff / exact).max())
    del exact, bound, acc64, via_spmv, pr

    # BFS from the vertex of highest out-degree to its fixed point; each
    # level's new vertices equal to the spmv kernel's expansion of the frontier
    source = int(out_deg.argmax())
    visited = torch.zeros(v, dtype=torch.bool, device=dev)
    visited[source] = True
    frontier = visited.clone()
    levels, bfs_ms = 0, []
    while True:
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with counting(step_launches):
            a.record()
            nxt, new = step_bfs(src, dst, visited, frontier)
            b.record()
            torch.cuda.synchronize()
        bfs_ms.append(a.elapsed_time(b))
        with counting(check_launches):
            want = (spmv(tiles, frontier.float()) > 0) & ~visited
        if not torch.equal(new, want):
            raise AssertionError(f"graph engine: BFS level {levels + 1} differs from the spmv kernel's expansion "
                                 f"({int((new != want).sum())} vertices)")
        if not bool(new.any()):
            break
        levels += 1
        visited, frontier = nxt, new
    reached = int(visited.sum())
    torch.cuda.synchronize()
    if any(step_launches.values()):
        raise AssertionError(f"graph engine: the cells' steps launched kernels: {step_launches}")
    if min(check_launches.values()) == 0:
        raise AssertionError(f"graph engine: a check's kernel did not launch: {check_launches}")
    # both kernels at this size, beside the step (counted in neither)
    spmv_ms = time_ms(lambda: spmv(tiles, contrib), warmup=1, batches=3, per_batch=5)
    counts = torch.zeros(v, dtype=torch.int32, device=dev)
    dc_ms = time_ms(lambda: count_into(src, counts), warmup=1, batches=3, per_batch=5)
    bincount_ms = time_ms(lambda: torch.bincount(src, minlength=v), warmup=1, batches=3, per_batch=5)
    n_rows = tiles.row_ptr.shape[0] - 1
    record = {
        "V": v, "E": e, "rmat_scale": scale, "rmat_s": rmat_s, "build_tiles_s": tiles_s,
        "pr_step_ms_median": pr_ms, "pr_step_ms": ms, "pr_edges_per_s": e / (pr_ms / 1e3),
        # each argument read once and the ranks written once, at the card's memory rate
        "pr_step_bound_ms": (2 * e * 4 + 3 * v * 4) / bw * 1e3,
        "pr_step_device_ms_by_kernel": pr_kernels, "pr_step_device_busy_ms": sum(by_kernel.values()),
        # bytes read or written once: sources, offsets, the vector, the sums
        "spmv_sweep_ms": spmv_ms, "spmv_sweep_bound_ms": (e * 4 + (n_rows + 1) * 8 + v * 4 + n_rows * 4) / bw * 1e3,
        # the ids once, the counters read and written once
        "degree_count_ms": dc_ms, "degree_count_bound_ms": (e * 4 + 2 * v * 4) / bw * 1e3,
        "degree_count_library_ms": bincount_ms,
        "pr_max_rel_err_vs_float64": errs, "bfs_source": source, "bfs_levels": levels,
        "bfs_reached": reached, "bfs_step_ms": bfs_ms, "bfs_ms_total": float(sum(bfs_ms)),
        "bfs_edges_per_s": e * len(bfs_ms) / (sum(bfs_ms) / 1e3),
        "peak_bytes": torch.cuda.max_memory_allocated(),
        "step_launches": step_launches, "check_launches": check_launches,
        "phase_s": time.perf_counter() - t_phase,
    }
    del src, dst, tiles, visited, frontier, out_deg, in_deg, counts
    return record


def dryrun_path(dev: torch.device, bw: float) -> dict:
    """Phase 15: the dry-run slice. (a) the sweep runs in ``DRYRUN_WORKERS``
    processes (meta traces: CPU only) while (b) runs on the card."""
    from repro_torch.configs import all_cells, get_arch

    mod = get_arch("paper-graph-engine")
    cells = all_cells() + [("paper-graph-engine", s) for s in mod.SHAPES]
    pr_cell, bfs_cell = mod.make_cell("pr_iteration"), mod.make_cell("bfs_expand")
    e, v = pr_cell.abstract_args[0].shape[0], pr_cell.abstract_args[2].shape[0]
    # the longest traces first: train cells, deepest configs
    order = sorted(cells, key=lambda c: (not c[1].startswith("train"), c[0] not in ("granite-34b", "grok-1-314b")))
    t0 = time.perf_counter()
    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=min(DRYRUN_WORKERS, max((os.cpu_count() or 2) - 2, 1)),
        mp_context=multiprocessing.get_context("spawn"))
    try:
        futures = {c: pool.submit(dryrun_cell, *c) for c in order}
        engine = graph_engine_at_scale(dev, bw, pr_cell.step_fn, bfs_cell.step_fn, v, e)
        log(json.dumps({"dryrun_graph_engine": engine}))
        records = [futures[c].result() for c in cells]
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    sweep_s = time.perf_counter() - t0
    # the records as the CLI's --single writes them
    out = ROOT / "build" / "dryrun"
    out.mkdir(parents=True, exist_ok=True)
    paths = [out / f"{r['arch']}__{r['shape']}__single.json" for r in records]
    for path, r in zip(paths, records):
        path.write_text(json.dumps(r, indent=1))
    written = sum(path.is_file() for path in set(paths))
    apart = check_dryrun(records)
    card_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    for r in records:
        log(f"  dryrun {r['cell']}: lower_s {r['lower_s']} flops {r['full']['flop_counter_flops']} "
            f"args {r['full']['memory']['argument_bytes_total'] / 1e9:.2f} GB (card {card_gb:.1f} GB), "
            f"per chip {r['full']['memory']['argument_bytes'] / 1e9:.3f} GB, wall {r['wall_s']:.1f} s")
    summary = {
        "records": len(records), "written": written, "cells": len(cells),
        "trips_exact": sum("trip1" in r for r in records) - len(apart),
        "trips_one_microbatch_apart": {r["cell"]: {"full": r["full"]["flop_counter_flops"],
                                                   "scaled": r["scaled"]["flop_counter_flops_scaled"]}
                                       for r in records if r["cell"] in apart},
        "sweep_wall_s": sweep_s, "trace_cpu_s": sum(r["wall_s"] for r in records),
        "lower_s": {r["cell"]: r["lower_s"] for r in records},
    }
    log(json.dumps({"dryrun_sweep": summary}))
    if len(records) != 42 or written != 42:
        raise AssertionError(f"dry-run: {len(records)} of 42 records, {written} written")
    return {"engine": engine, "sweep": summary}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if torch.cuda.device_count() != 1:
        print(f"chip_smoke: needs one CUDA device, sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.append(str(ROOT / "tests"))  # _torch_gnn, _torch_recsys: phases 13's and 14's card cases
    from repro_torch.kernels import _build

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in full float32
    torch.backends.cudnn.allow_tf32 = False
    # bf16 products (the LM path) accumulate in float32 throughout, as the
    # reference's dots do, not in cuBLAS's reduced-precision split reductions
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    t_start = time.perf_counter()

    # 1. environment ---------------------------------------------------------
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    log(smi)
    bw = hbm_bytes_per_s(smi)

    # 2. build ---------------------------------------------------------------
    t0 = time.perf_counter()
    secs = _build.build("spmv", "degree_count", "scoring", "embedding_bag", "flash_attention")
    log(f"build: {time.perf_counter() - t0:.2f} s wall, per source {secs} (nvcc sm_90a)")
    for name, text in _build.build_log.items():
        for line in text.splitlines():
            if any(k in line for k in ("registers", "spill", "entry function", "C75", "warning")):
                log(f"  {name}: {line.strip()[:200]}")

    # 3-5. the graph engine: kernels, main path, timing -----------------------
    t0 = time.perf_counter()
    kernels = graph_path(dev, bw)
    gc.collect()
    torch.cuda.empty_cache()  # the RMAT graph is gone; the data sets need the room
    log(f"graph phase: {time.perf_counter() - t0:.1f} s")

    # 6. the SNAP surrogates at full size ------------------------------------------
    t0 = time.perf_counter()
    real_launches, held = datasets_path(dev, bw)
    log(f"datasets phase: {time.perf_counter() - t0:.1f} s")

    # 7. dynamic ingest at RMAT scale 20 ----------------------------------------------
    t0 = time.perf_counter()
    dyn_launches = dynamic_path(dev)
    gc.collect()
    torch.cuda.empty_cache()  # the snapshots are gone; the retrieval tables need the room
    log(f"dynamic phase: {time.perf_counter() - t0:.1f} s")
    spmv = next(k for k in kernels if k["name"] == "spmv")
    spmv["launches_by_phase"] = {"rmat_sf20_fig20": spmv["launches"], **real_launches, **dyn_launches}
    spmv["max_abs_err"] = max(spmv["max_abs_err"], held["spmv_in_sweep"]["max_abs_err"])
    spmv["livejournal_in_sweep"] = held["spmv_in_sweep"]
    dc = next(k for k in kernels if k["name"] == "degree_count")
    dc["livejournal_whole_graph"] = held["degree_count_whole_graph"]

    # 8. the retrieval server at full width ---------------------------------------
    t0 = time.perf_counter()
    kernels += retrieval_path(dev, bw)
    log(f"retrieval phase: {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()  # the retrieval tables are gone; the LM needs the room

    # 9. LM serving at full width ----------------------------------------------------
    t0 = time.perf_counter()
    kernels += lm_path(dev, bw)
    log(f"lm phase: {time.perf_counter() - t0:.1f} s")

    # 10. MoE serving at full width ---------------------------------------------------
    gc.collect()
    torch.cuda.empty_cache()  # TinyLlama is gone; grok-1's 42.6 GB need the room
    t0 = time.perf_counter()
    moe_runs = moe_path(dev, bw)
    log(f"moe phase: {time.perf_counter() - t0:.1f} s")
    flash = next(k for k in kernels if k["name"] == "flash_attention")
    flash["launches_by_phase"] = {"lm_tinyllama": flash["launches"],
                                  **{f"moe_{r['record']['arch']}": r["launches"] for r in moe_runs}}
    flash["shapes"] += [r["flash_row"] for r in moe_runs]
    flash["max_abs_err"] = max(flash["max_abs_err"], *(r["flash_row"]["max_abs_err"]["bf16"] for r in moe_runs))

    # 11. LM training at full width --------------------------------------------------
    gc.collect()
    torch.cuda.empty_cache()  # arctic is gone; TinyLlama's masters, moments and grads need the room
    t0 = time.perf_counter()
    train = lm_train_path(dev, bw)
    log(f"lm training phase: {time.perf_counter() - t0:.1f} s")
    flash["launches_by_phase"]["lm_train_tinyllama_per_step"] = train["launches_per_step"]
    flash["shapes"].append(train["times"])

    # 12. the smoke configs' head dim (16) ----------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    small = small_head_dims_path(dev, bw)
    log(f"small head dims phase: {time.perf_counter() - t0:.1f} s")
    flash["launches_by_phase"]["smoke_dh16"] = small["launches"]
    flash["shapes"] += small["shapes"]
    flash["max_abs_err"] = max(flash["max_abs_err"], small["shapes"][0]["max_abs_err"]["bf16"],
                               small["shapes"][1]["max_abs_err"]["float32"])

    # 13. the GNN family --------------------------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    gnn = gnn_path(dev)
    log(f"gnn phase: {time.perf_counter() - t0:.1f} s")
    for k in kernels:
        k.setdefault("launches_by_phase", {})["gnn"] = gnn["kernel_launches"][k["name"]]

    # 14. two-tower training at full width --------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    recsys = recsys_train_path(dev)
    log(f"recsys training phase: {time.perf_counter() - t0:.1f} s")
    bag = next(k for k in kernels if k["name"] == "embedding_bag")
    bag["launches_by_phase"]["recsys_train"] = recsys["launches_main_path"]
    bag["launches_by_phase"]["recsys_serve"] = {r["shape"]: r["launches"] for r in recsys["serve"]}
    bag["max_abs_err"] = max(bag["max_abs_err"], *(f["max_abs_err"]["forward"] for f in recsys["functions"]))
    bag["training"] = {"functions": recsys["functions"], "serve": recsys["serve"],
                       "profiled_step": recsys["full_width"]["profiled_step"]}

    # 15. the dry-run slice --------------------------------------------------
    gc.collect()
    torch.cuda.empty_cache()  # the two-tower tables are gone; the 2^30 edges need the room
    t0 = time.perf_counter()
    dry = dryrun_path(dev, bw)
    log(f"dry-run phase: {time.perf_counter() - t0:.1f} s")
    for k in kernels:  # the cells' steps launch none; the checks' launches apart
        k["launches_by_phase"]["dryrun_graph_engine"] = dry["engine"]["step_launches"][k["name"]]
    for k in (spmv, dc):
        k["check_launches_by_phase"] = {"dryrun_graph_engine": dry["engine"]["check_launches"][k["name"]]}

    # 16. isolation -------------------------------------------------------------
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
