#!/usr/bin/env python3
"""Time the port's flash-attention kernel against variants of its source, on
one card, in one process.

    python3 tools/flash_ab.py [variant.cu ...]

Builds ``src/repro_torch/csrc/flash_attention.cu`` (the kernel in the tree)
and every variant named (each a whole copy of that file with its
``flash_attention`` C entry), prints each build's ptxas notes (registers,
spills and wgmma serialization, C75xx), holds the tree's kernel against its
plain version at small shapes in bf16 and fp16, and times at four bf16
shapes, in turn: the tree's kernel, each variant (with its largest
difference from the tree's output), the tree's kernel again and
``scaled_dot_product_attention``. Times are CUDA-event medians in ms per
launch. Needs a CUDA device; prints the card's name and power limit first.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch
from torch.nn import functional as F

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.attention import flash_attention_cuda, flash_attention_plain  # noqa: E402

# (name, (B, S, H, K, Dh), launches per timed batch)
SHAPES = (
    ("served", (8, 2048, 32, 4, 64), 20),
    ("prefill_32k", (1, 32768, 32, 4, 64), 3),
    ("dh128", (8, 2048, 32, 8, 128), 10),
    ("dh32", (8, 2048, 32, 4, 32), 10),
)
NOTES = ("registers", "spill", "C75", "error")


def notes(log: str) -> list[str]:
    return [line.strip()[:200] for line in log.splitlines() if any(n in line for n in NOTES)]


def build_variants(paths: list[str]) -> dict[str, ctypes.CDLL]:
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for path in paths:
        out = out_dir / f"{Path(path).stem}.so"
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out), path]
        procs[path] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    _build.build("flash_attention")
    for line in notes(_build.build_log.get("flash_attention", "")):
        print("tree:", line)
    libs = {}
    for path, (proc, out) in procs.items():
        log, _ = proc.communicate()
        for line in notes(log):
            print(f"{Path(path).name}:", line)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {path}")
        lib = ctypes.CDLL(str(out))
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.flash_attention.argtypes = [p, p, p, p, i64, i64, i64, i64, i64, ctypes.c_int, p]
        lib.flash_attention.restype = ctypes.c_int
        libs[Path(path).name] = lib
    return libs


def run_variant(lib: ctypes.CDLL, q, k, v):
    o = torch.empty_like(q)
    b, s, h, dh = q.shape
    status = lib.flash_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, s, h,
                                 k.shape[2], dh, 1, torch.cuda.current_stream().cuda_stream)
    _build.check(status, "variant")
    return o


def time_ms(fn, per_batch: int, batches: int = 5) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(batches):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(per_batch):
            fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return sorted(a.elapsed_time(b) / per_batch for a, b in pairs)[batches // 2]


def check_tree(dev) -> None:
    """The tree's kernel against its plain version (the card tests' bf16 and
    fp16 tolerances) over Dh, G and ragged S."""
    for dtype, rtol, atol in ((torch.bfloat16, 1.6e-2, 1e-5), (torch.float16, 1e-3, 1e-3)):
        for dh in (32, 64, 128):
            for h, kh in ((4, 4), (32, 4)):
                for s in (1, 127, 129, 1000):
                    g = torch.Generator(device=dev).manual_seed(s + dh + h)
                    q = torch.randn(2, s, h, dh, device=dev, generator=g).to(dtype)
                    k, v = (torch.randn(2, s, kh, dh, device=dev, generator=g).to(dtype) for _ in range(2))
                    torch.testing.assert_close(flash_attention_cuda(q, k, v),
                                               flash_attention_plain(q, k, v, block_kv=64), rtol=rtol, atol=atol)
    print("tree kernel matches the plain version")


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_ab: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    dev = torch.device("cuda")
    libs = build_variants(sys.argv[1:])
    check_tree(dev)
    for name, (b, s, h, kh, dh), n in SHAPES:
        g = torch.Generator(device=dev).manual_seed(0)
        q = torch.randn(b, s, h, dh, device=dev, generator=g).bfloat16()
        k, v = (torch.randn(b, s, kh, dh, device=dev, generator=g).bfloat16() for _ in range(2))
        ref = flash_attention_cuda(q, k, v).float()
        row = {"tree": time_ms(lambda: flash_attention_cuda(q, k, v), n)}
        for vname, lib in libs.items():
            row[vname] = time_ms(lambda: run_variant(lib, q, k, v), n)
            row[vname + "_max_diff"] = float((run_variant(lib, q, k, v).float() - ref).abs().max())
        row["tree_again"] = time_ms(lambda: flash_attention_cuda(q, k, v), n)
        row["library"] = time_ms(lambda: F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True, enable_gqa=True), n)
        print(json.dumps({name: row}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
