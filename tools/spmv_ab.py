#!/usr/bin/env python3
"""Time the port's spmv kernel against an older source and edited copies of
it on RMAT scale 20 (the graph main path's graph), on one card, in one
process.

    python3 tools/spmv_ab.py [variant.cu ...]

Builds ``src/repro_torch/csrc/spmv.cu``, the base source (the file
``--base`` names, by default ``build/ab/spmv_d57fe52.cu``, which the tool
writes from ``git show d57fe52:src/repro_torch/csrc/spmv.cu`` when it is
missing and git is at hand: the warp-per-row kernel with a block per row of
more than 4,096 edges, C entry ``spmv_rows``) and every variant named (whole
copies of the tree's file; each one's ``kBlockEdges`` is read from its text
and its tables are cut to match), and prints their ptxas notes. On the
in-edge tables of ``rmat_graph(20, seed=3)`` (PageRank-pull's) and the
out-edge ones (BFS's) it holds each kernel against the plain version
(1e-4 relative: sums in another order; BFS counts exactly) and against
itself twice in bits, then times each, in turns (tree, base, variants, tree,
base): the full sweep as a CUDA-event median in ms per launch, and the
profiler's device time per launch of the full sweep, of the 16 slices of
T/16 tiles that the main path's gang of 16 launches, and of the T/2
two-tile ranges (the device's own time: back-to-back launches of a few
microseconds time the host, whose path differs between the tree and the
older entries); then the gather-only probe once. The card's name and power
limit come first.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import POOL, SCALE, SEED, SPMV_RTOL, SPMV_ATOL, device_ms_per_call, time_ms  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.spmv import (  # noqa: E402
    BLOCK_EDGES,
    DST_TILE,
    build_tiles,
    gather_probe_cuda,
    row_blocks,
    spmv_rows_plain,
    spmv_tiles,
)

BASE_COMMIT = "d57fe52"
SOURCE = "src/repro_torch/csrc/spmv.cu"
BASE_LONG_ROW = 4096  # the base source's kLongRow
NOTES = ("registers", "spill", "error", "warning")


def base_source(path: Path) -> Path:
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        text = subprocess.run(["git", "show", f"{BASE_COMMIT}:{SOURCE}"], cwd=ROOT, capture_output=True,
                              text=True, check=True).stdout
        path.write_text(text)
    return path


def build(paths: list[Path], base: Path) -> dict[str, tuple[ctypes.CDLL, int | None]]:
    """name -> (library, its kBlockEdges; None for the base source)."""
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for path in [base, *paths]:
        out = out_dir / f"{path.stem}.so"
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(path)]
        procs[path] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    _build.build("spmv")
    for line in _build.build_log.get("spmv", "").splitlines():
        if any(n in line for n in NOTES):
            print("tree ptxas:", line.strip()[:200])
    libs = {}
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    for path, (proc, out) in procs.items():
        log, _ = proc.communicate()
        for line in log.splitlines():
            if any(n in line for n in NOTES):
                print(f"{path.name}:", line.strip()[:200])
        if proc.returncode != 0:
            print(f"{path.name}: nvcc failed, left out", flush=True)
            continue
        lib = ctypes.CDLL(str(out))
        if path == base:
            lib.spmv_rows.argtypes = [p, i64, p, p, p, p, i64, i64, p]
            lib.spmv_rows.restype = ctypes.c_int
            libs[path.name] = (lib, None)
        else:
            lib.spmv_blocks.argtypes = [p, p, p, p, p, p, p, i64, i64, i64, i64, p]
            lib.spmv_blocks.restype = ctypes.c_int
            edges = int(re.search(r"constexpr int kBlockEdges = (\d+);", path.read_text()).group(1))
            libs[path.name] = (lib, edges)
    return libs


def run_base(lib, tables, long_rows, contrib, t0, t1):
    """The base source on tiles [t0, t1): its long rows listed as it wants."""
    r0, r1 = t0 * DST_TILE, t1 * DST_TILE
    lo, hi = np.searchsorted(long_rows[1], [r0, r1])
    rows = long_rows[0][lo:hi]
    out = torch.empty(r1 - r0, device=contrib.device)
    status = lib.spmv_rows(tables.row_ptr[r0:].data_ptr(), r1 - r0, tables.src.data_ptr(), contrib.data_ptr(),
                           out.data_ptr(), rows.data_ptr(), rows.shape[0], r0,
                           torch.cuda.current_stream().cuda_stream)
    _build.check(status, "base")
    return out


def run_blocks(lib, tables, contrib, t0, t1):
    """A variant of the tree's source on tiles [t0, t1) of tables cut to its
    block size."""
    r0, r1 = t0 * DST_TILE, t1 * DST_TILE
    out = torch.empty(r1 - r0, device=contrib.device)
    nb = tables.n_blocks
    base = tables.blocks.data_ptr()
    status = lib.spmv_blocks(tables.row_ptr.data_ptr(), tables.src.data_ptr(), contrib.data_ptr(), out.data_ptr(),
                             base, base + 4 * (nb + 1), tables.scratch.data_ptr(), nb,
                             int(tables.tile_blocks[t0]), int(tables.tile_blocks[t1]), r0,
                             torch.cuda.current_stream().cuda_stream)
    _build.check(status, "variant")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", type=Path)
    ap.add_argument("--base", type=Path, default=_build.BUILD_DIR.parent / "ab" / f"spmv_{BASE_COMMIT}.cu")
    args = ap.parse_args()
    base = base_source(args.base)
    if not torch.cuda.is_available():
        print("spmv_ab: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    libs = build(args.variants, base)
    from repro_torch import algorithms as alg
    from repro_torch.graph import rmat_graph

    dev = torch.device("cuda")
    g = rmat_graph(SCALE, seed=SEED, device=dev)
    V = g.num_vertices
    pr = alg.PageRankExecutor(g, mode="pull", max_iters=1, tol=0)
    pr.start()
    frontier = torch.zeros(V, dtype=torch.float32, device=dev)
    frontier[torch.randperm(V, generator=torch.Generator().manual_seed(SEED))[:4096].to(dev)] = 1.0
    for what, (src, dst), contrib, exact in (("in", pr.pull_edges(), pr.contrib, False),
                                              ("out", (g.src, g.dst), frontier, True)):
        t = build_tiles(src, dst, V)
        tables = {BLOCK_EDGES: t}
        for _, edges in libs.values():
            if edges is not None and edges not in tables:  # the same tables cut for the variant
                blocks, tile_blocks = row_blocks(t.row_ptr, edges)
                tables[edges] = dataclasses.replace(
                    t, blocks=blocks, tile_blocks=tile_blocks.cpu().numpy(),
                    scratch=torch.zeros(2, blocks.shape[1] - 1, dtype=torch.int32, device=dev))
        T = t.n_tiles
        counts = t.row_ptr[1:] - t.row_ptr[:-1]
        long_rows = torch.nonzero(counts > BASE_LONG_ROW).flatten()
        long_rows = (long_rows.to(torch.int32), long_rows.cpu().numpy())
        calls = {"tree": lambda a, b: spmv_tiles(t, contrib, a, b).reshape(-1)}
        for name, (lib, edges) in libs.items():
            if edges is None:
                calls[name] = lambda a, b, lib=lib: run_base(lib, t, long_rows, contrib, a, b)
            else:
                calls[name] = lambda a, b, lib=lib, tb=tables[edges]: run_blocks(lib, tb, contrib, a, b)
        w = T // POOL
        checks = {}
        for name, fn in calls.items():
            for a, b in ((0, T), (w, 2 * w), (T // 3, T - 5)):
                got, again = fn(a, b), fn(a, b)
                want = spmv_rows_plain(t.row_ptr[a * DST_TILE : b * DST_TILE + 1], t.src, contrib)
                if exact:
                    ok = torch.equal(got, want)
                else:
                    ok = torch.allclose(got, want, rtol=SPMV_RTOL, atol=SPMV_ATOL)
                checks[f"{name} [{a}, {b})"] = {"plain": bool(ok), "same_bits_twice": bool(torch.equal(got, again)),
                                                "max_abs_err": float((got - want).abs().max())}
        row = {"table": what, "tiles": T, "edges": int(t.row_ptr[-1]), "checks": checks}
        order = ["tree", *libs, "tree", *[n for n in libs if libs[n][1] is None]]
        shapes = {"full": [(0, T)], "slice": [(a, a + w) for a in range(0, T, w)],
                  "two_tiles": [(a, a + 2) for a in range(0, T, 2)]}
        for name in order:
            fn = calls[name]
            entry = {"full_ms": time_ms(lambda: fn(0, T))}
            for shape, ranges in shapes.items():  # the device's own time per launch

                def launch_all(fn=fn, ranges=ranges):
                    for a, b in ranges:
                        fn(a, b)

                entry[f"{shape}_device_ms"] = device_ms_per_call(launch_all, calls=3)[0] / len(ranges)
            row.setdefault(name, []).append(entry)
        row["gather_probe_ms"] = time_ms(lambda: gather_probe_cuda(t.src, contrib))
        print(json.dumps(row), flush=True)
        if not all(c["plain"] and c["same_bits_twice"] for c in checks.values()):
            print(f"spmv_ab: a kernel disagrees on the {what}-edge tables", file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
