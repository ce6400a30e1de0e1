#!/usr/bin/env python3
"""Time the port's EmbeddingBag kernel against an older source, edited
copies of it, and ``F.embedding_bag``, at the retrieval server's two bag
shapes, on one card, in one process; and hold the kernels to each other bit
for bit.

    python3 tools/embag_ab.py [variant.cu ...]

Builds ``src/repro_torch/csrc/embedding_bag.cu``, the base source (the
file ``--base`` names, by default ``build/ab/embedding_bag_d57fe52.cu``,
which the tool writes from ``git show d57fe52:src/repro_torch/csrc/
embedding_bag.cu`` when it is missing and git is at hand: the two-launch
warp-per-bag kernel, whose C entry also takes an int64 offsets scratch) and
every variant named (whole copies of the tree's file), and prints their
ptxas notes. The shapes are those of ``configs/two_tower_retrieval.py``:
``item_tags`` (2^20 bags of 8 ids over a 131,072 x 256 table) and
``user_history`` (512 bags of 32 ids over a 1,048,576 x 256 table), ids and
weights from a seed, the last quarter of each bag's weights 0. Every kernel
must equal the tree's in bits and the plain version within 1e-5 / 1e-6.
Times are ms per call, in turns (tree, base, variants, tree, base): CUDA
events around 20 back-to-back calls (median of 5), and the profiler's device
time per call with the kernel launches per call. The card's name and power
limit come first.
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

from chip_smoke import device_ms_per_call, time_ms  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.embedding_bag import embedding_bag_cuda, embedding_bag_plain  # noqa: E402

BASE_COMMIT = "d57fe52"
SOURCE = "src/repro_torch/csrc/embedding_bag.cu"
SHAPES = (("item_tags", 1 << 20, 8, 131_072), ("user_history", 512, 32, 1_048_576))
D = 256
RTOL, ATOL = 1e-5, 1e-6
NOTES = ("registers", "spill", "error", "warning")


def base_source(path: Path) -> Path:
    if not path.exists():
        path.parent.mkdir(parents=True, exist_ok=True)
        text = subprocess.run(["git", "show", f"{BASE_COMMIT}:{SOURCE}"], cwd=ROOT, capture_output=True,
                              text=True, check=True).stdout
        path.write_text(text)
    return path


def build(paths: list[Path], base: Path) -> dict[str, tuple[ctypes.CDLL, bool]]:
    """name -> (library, whether it is the base source with the offsets
    scratch in its C entry)."""
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for path in [base, *paths]:
        out = out_dir / f"{path.stem}.so"
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(path)]
        procs[path] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    _build.build("embedding_bag")
    for line in _build.build_log.get("embedding_bag", "").splitlines():
        if any(n in line for n in NOTES):
            print("tree ptxas:", line.strip()[:200])
    libs = {}
    for path, (proc, out) in procs.items():
        log, _ = proc.communicate()
        for line in log.splitlines():
            if any(n in line for n in NOTES):
                print(f"{path.name}:", line.strip()[:200])
        if proc.returncode != 0:
            print(f"{path.name}: nvcc failed, left out", flush=True)
            continue
        lib = ctypes.CDLL(str(out))
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        old = path == base
        # the tree's entry takes the table's rows (jnp.take's id rule); the base's the offsets scratch
        lib.embedding_bag.argtypes = [p, *([] if old else [i64]), i64, p, p, p, i64, *([p] if old else []), p, i64, p]
        lib.embedding_bag.restype = ctypes.c_int
        libs[path.name] = (lib, old)
    return libs


def run(entry, table, ids, segs, w, bags):
    lib, old = entry
    out = torch.empty(bags, table.shape[1], device=table.device)
    scratch = [torch.empty(bags + 1, dtype=torch.int64, device=table.device).data_ptr()] if old else []
    rows = [] if old else [table.shape[0]]
    status = lib.embedding_bag(table.data_ptr(), *rows, table.shape[1], ids.data_ptr(), segs.data_ptr(),
                               w.data_ptr(), ids.shape[0], *scratch, out.data_ptr(), bags,
                               torch.cuda.current_stream().cuda_stream)
    _build.check(status, "variant")
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("variants", nargs="*", type=Path)
    ap.add_argument("--base", type=Path, default=_build.BUILD_DIR.parent / "ab" / f"embedding_bag_{BASE_COMMIT}.cu")
    args = ap.parse_args()
    base = base_source(args.base)
    if not torch.cuda.is_available():
        print("embag_ab: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    libs = build(args.variants, base)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    for field, bags, hot, vocab in SHAPES:
        table = torch.randn(vocab, D, device=dev, generator=g).mul_(0.01)
        ids = torch.randint(0, vocab, (bags * hot,), device=dev, generator=g, dtype=torch.int32)
        w = torch.rand(bags, hot, device=dev, generator=g)
        w[:, hot - hot // 4 :] = 0.0
        w = w.reshape(-1).contiguous()
        segs = torch.arange(bags, dtype=torch.int32, device=dev).repeat_interleave(hot)
        offsets = torch.arange(0, bags * hot, hot, dtype=torch.int32, device=dev)

        def tree():
            return embedding_bag_cuda(table, ids, segs, w, bags)

        want = tree()
        torch.testing.assert_close(want, embedding_bag_plain(table, ids, segs, w, bags), rtol=RTOL, atol=ATOL)
        calls = {"tree": tree}
        for name, entry in libs.items():
            calls[name] = lambda entry=entry: run(entry, table, ids, segs, w, bags)
        row = {"shape": f"{field}: {bags} bags x {hot} ids, table {vocab} x {D}"}
        for name, fn in calls.items():
            got = fn()
            row.setdefault("equal_bits_to_tree", {})[name] = bool(torch.equal(got, want))
            del got
        order = ["tree", *libs, "tree", *[n for n in libs if libs[n][1]]]
        for name in order:
            ms = time_ms(calls[name])
            dev_ms, launches = device_ms_per_call(calls[name])
            row.setdefault(name, []).append({"ms": ms, "device_ms": dev_ms, "launches_per_call": launches})

        def library():
            return torch.nn.functional.embedding_bag(ids, table, offsets, mode="sum", per_sample_weights=w)

        lib_dev, lib_launches = device_ms_per_call(library)
        row["library"] = {"ms": time_ms(library), "device_ms": lib_dev, "launches_per_call": lib_launches}
        print(json.dumps(row), flush=True)
        if not all(row["equal_bits_to_tree"].values()):
            print(f"embag_ab: a kernel differs from the tree's in bits at {field}", file=sys.stderr)
            return 1
        del table
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
