#!/usr/bin/env python3
"""Time the port's degree-count kernels against an older source and edited
copies of the tree's on RMAT scale 20 (the graph main path's graph), on one
card, in one process.

    python3 tools/degree_count_ab.py [variant.cu ...]

Builds ``src/repro_torch/csrc/degree_count.cu``, the base source (the file
``--base`` names, by default ``build/ab/degree_count_62dc202.cu``, which the
tool writes from ``git show 62dc202:src/repro_torch/csrc/degree_count.cu``
when it is missing and git is at hand: one thread per id, one global atomic
per id, C entry ``degree_count``), an empty kernel (the launch floor), and
every variant named (whole copies of the tree's file, called through their
own ``degree_count`` dispatch), and prints their ptxas notes. On the
endpoint table ``[src; dst] % C`` of ``rmat_graph(20, seed=3)`` it holds
every kernel against the base source in bits: the full table at C = 2^20
and C = 1,000,003, a range that starts at an odd edge, the package whose
src row is one id, and every 16 Ki-edge package of the main path. Then it
times each, in turns (tree, base, tree kernels forced, variants, tree,
base): the full table as a CUDA-event median in ms per launch and as the
profiler's device time, the src and dst rows alone (device time), and the
1,024 packages one launch each (the profiler's device time per launch: the
mean and the worst). Then the tree's two kernels on ranges of 2^14 to
2^23 edges (device ms: where the private kernel overtakes the runs
kernel), and last the empty kernel's device time per launch. Exits
1 if any kernel disagrees with the base in any bit. The card's name and
power limit come first.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

from chip_smoke import SCALE, SEED, device_ms_each, device_ms_per_call, time_ms  # noqa: E402
from repro_torch.algorithms.degree_count import PACKAGE_EDGES  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.degree_count.degree_count import (  # noqa: E402
    _degree_count_variant,
    degree_count_cuda,
)

BASE_COMMIT = "62dc202"
SOURCE = "src/repro_torch/csrc/degree_count.cu"
NOTES = ("registers", "spill", "error", "warning")
EMPTY_SOURCE = """
#include <cuda_runtime.h>
__global__ void empty_kernel() {}
extern "C" int launch_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
"""
# the tree's kernels forced, beside its own dispatch
TREE_FORCED = ("runs", "private")


def base_source(path: Path) -> Path:
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        text = subprocess.run(["git", "show", f"{BASE_COMMIT}:{SOURCE}"], cwd=ROOT, capture_output=True,
                              text=True, check=True).stdout
        path.write_text(text)
    return path


def build(paths: list[Path], base: Path) -> dict[str, ctypes.CDLL]:
    """name -> loaded library, for the base, the empty kernel and each
    variant; the tree's source is built by ``_build``."""
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    empty = base.parent / "empty_kernel.cu"
    empty.write_text(EMPTY_SOURCE)
    procs = {}
    for path in [base, empty, *paths]:
        out = out_dir / f"{path.stem}.so"
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(path)]
        procs[path] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    _build.build("degree_count")
    for line in _build.build_log.get("degree_count", "").splitlines():
        if any(n in line for n in NOTES):
            print("tree ptxas:", line.strip()[:200])
    libs = {}
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
    for path, (proc, out) in procs.items():
        log, _ = proc.communicate()
        for line in log.splitlines():
            if any(n in line for n in NOTES):
                print(f"{path.name}:", line.strip()[:200])
        if proc.returncode != 0:
            if path in (base, empty):
                raise RuntimeError(f"{path.name}: nvcc failed")
            print(f"{path.name}: nvcc failed, left out", flush=True)
            continue
        lib = ctypes.CDLL(str(out))
        if path == empty:
            lib.launch_empty.argtypes = [p]
            lib.launch_empty.restype = ctypes.c_int
        else:
            lib.degree_count.argtypes = [p, i64, i64, i64, p, i32, p]
            lib.degree_count.restype = ctypes.c_int
        libs[path.name] = lib
    return libs


def shape(ids: torch.Tensor) -> tuple[int, int, int]:
    """(n, rows, row_stride) as the wrappers read them."""
    if ids.dim() == 1:
        return ids.shape[0], 1, ids.shape[0]
    return ids.shape[1], ids.shape[0], ids.stride(0)


def run_lib(lib, ids, counts):
    """The ``degree_count`` C entry of a built source (the base's, or a
    variant's own dispatch)."""
    n, rows, stride = shape(ids)
    status = lib.degree_count(ids.data_ptr(), n, rows, stride, counts.data_ptr(), counts.shape[0],
                              torch.cuda.current_stream().cuda_stream)
    _build.check(status, "degree_count")
    return counts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", type=Path)
    ap.add_argument("--base", type=Path,
                    default=_build.BUILD_DIR.parent / "ab" / f"degree_count_{BASE_COMMIT}.cu")
    args = ap.parse_args()
    base = base_source(args.base)
    if not torch.cuda.is_available():
        print("degree_count_ab: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    libs = build(args.variants, base)
    from repro_torch.graph import rmat_graph

    dev = torch.device("cuda")
    g = rmat_graph(SCALE, seed=SEED, device=dev)
    V, E = g.num_vertices, g.num_edges
    table = (torch.stack([g.src, g.dst]) % V).to(torch.int32)
    odd = (torch.stack([g.src, g.dst]) % 1_000_003).to(torch.int32)
    del g
    n_pkg = -(-E // PACKAGE_EDGES)
    packages = [table[:, p * PACKAGE_EDGES : min((p + 1) * PACKAGE_EDGES, E)] for p in range(n_pkg)]
    whole = table[0, : E // PACKAGE_EDGES * PACKAGE_EDGES].reshape(-1, PACKAGE_EDGES)
    one_id = (whole.amin(1) == whole.amax(1)).nonzero().flatten()
    hub = int(one_id[0]) if one_id.numel() else 0
    print(json.dumps({"edges": E, "packages": n_pkg, "packages_of_one_src_id": int(one_id.numel()),
                      "hub_package": hub}), flush=True)

    calls = {"tree": lambda ids, c: degree_count_cuda(ids, c)}
    for path in TREE_FORCED:
        calls[f"tree_{path}"] = lambda ids, c, path=path: _degree_count_variant(ids, c, path)
    for name, lib in libs.items():
        if name != "empty_kernel.cu":
            calls["base" if name == base.name else name] = lambda ids, c, lib=lib: run_lib(lib, ids, c)

    cases = {"full C=2^20": (table, V), "full C=1,000,003": (odd, 1_000_003),
             "odd start": (table[:, E // 3 + 1 : E // 3 + 1 + 3 * PACKAGE_EDGES + 5], V),
             "hub package": (packages[hub], V)}
    bad = []
    for case, (ids, c) in cases.items():
        want = run_lib(libs[base.name], ids, torch.zeros(c, dtype=torch.int32, device=dev))
        for name, fn in calls.items():
            if not torch.equal(fn(ids, torch.zeros(c, dtype=torch.int32, device=dev)), want):
                bad.append(f"{name} on {case}")
    for name, fn in calls.items():  # every package, each into its own counters
        want = torch.zeros(V, dtype=torch.int32, device=dev)
        got = torch.zeros(V, dtype=torch.int32, device=dev)
        for p in packages:
            want.zero_()
            got.zero_()
            run_lib(libs[base.name], p, want)
            if not torch.equal(fn(p, got), want):
                bad.append(f"{name} on a package")
                break
    print(json.dumps({"bits_equal_to_base": not bad, "differences": bad}), flush=True)

    counts = torch.zeros(V, dtype=torch.int32, device=dev)
    order = ["tree", "base", *[n for n in calls if n not in ("tree", "base")], "tree", "base"]
    rows = {}
    for name in order:
        fn = calls[name]
        counts.zero_()

        def launch_packages(fn=fn):
            for p in packages:
                fn(p, counts)

        entry = {
            "full_ms": time_ms(lambda: fn(table, counts)),
            "full_device_ms": device_ms_per_call(lambda: fn(table, counts), calls=5)[0],
            "src_row_device_ms": device_ms_per_call(lambda: fn(table[0], counts), calls=5)[0],
            "dst_row_device_ms": device_ms_per_call(lambda: fn(table[1], counts), calls=5)[0],
            "packages": device_ms_each(launch_packages, len(packages), "degree_count"),
        }
        rows.setdefault(name, []).append(entry)
        print(json.dumps({name: entry}), flush=True)
    # where the private kernel overtakes the runs kernel: ranges of 2^k
    # edges (2 rows) from a quarter into the table, device ms each
    cross = {}
    for k in range(14, 24):
        ids = table[:, E // 4 : E // 4 + (1 << k)]
        cross[2 << k] = {kern: device_ms_per_call(lambda kern=kern: _degree_count_variant(ids, counts, kern),
                                                  calls=5)[0] for kern in ("runs", "private")}
    faster = [n for n, t in cross.items() if t["private"] < t["runs"]]
    print(json.dumps({"crossover_device_ms": cross, "private_faster_from_ids": min(faster, default=None)}),
          flush=True)
    empty = libs["empty_kernel.cu"]

    def launch_empties():
        for _ in packages:
            _build.check(empty.launch_empty(torch.cuda.current_stream().cuda_stream), "empty")

    print(json.dumps({"empty_kernel": device_ms_each(launch_empties, len(packages), "empty_kernel")}), flush=True)
    if bad:
        print(f"degree_count_ab: kernels differ from the base: {bad}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
