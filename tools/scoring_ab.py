#!/usr/bin/env python3
"""Time the port's two scoring kernels against each other, and against
``torch.matmul`` in full float32, at the retrieval server's shapes, on one
card, in one process.

    python3 tools/scoring_ab.py [variant.cu ...]

Builds ``src/repro_torch/csrc/scoring.cu`` and every variant named (each a
whole copy of that file with its ``scoring_variant`` C entry, or an older
source whose only entry is ``scoring(q, c, out, B, N, D, stream)``, such as
the tiled SGEMM that ``git show <commit>:src/repro_torch/csrc/scoring.cu``
gives for a commit before the two kernels),
prints their ptxas notes
(registers, spills, wgmma serialization C75xx) and times, at N = 2^20
candidates of D = 256 (the corpus of ``configs/two_tower_retrieval.py``),
for each batch B: the streaming kernel, the tensor-core kernel at the tile
width the dispatch would give it, and the library call, each held against
the plain version at 1e-5. At the largest batches it also times the
tensor-core kernel's other tile widths. The crossover printed last is the
largest B at which the streaming kernel is faster: ``STREAM_MAX_BATCH`` in
``kernels/scoring/scoring.py`` and ``kStreamMaxBatch`` in the source. Times
are CUDA-event medians in ms per launch; the card's name and power limit
come first. A variant is timed beside the tree's kernel of the same path and
width, tree first, then the variant, then the tree again; an older source
beside ``scoring_cuda``'s dispatch.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.scoring import scoring_plain  # noqa: E402
from repro_torch.kernels.scoring.scoring import _scoring_path, _scoring_variant, scoring_cuda  # noqa: E402

N, D = 1 << 20, 256
BATCHES = (1, 2, 4, 8, 12, 16, 24, 32, 48, 64, 128, 256, 512)
NOTES = ("registers", "spill", "C75", "error", "warning")
TOL = 1e-5


def pow2_at_least(b: int, lo: int, hi: int) -> int:
    w = lo
    while w < b and w < hi:
        w *= 2
    return w


def build_variants(paths: list[str]) -> dict[str, ctypes.CDLL]:
    out_dir = _build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for path in paths:
        out = out_dir / f"{Path(path).stem}.so"
        cmd = [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(out), path]
        procs[path] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), out)
    _build.build("scoring")
    for line in _build.build_log.get("scoring", "").splitlines():
        if any(n in line for n in NOTES):
            print("ptxas:", line.strip()[:200])
    libs = {}
    for path, (proc, out) in procs.items():
        log, _ = proc.communicate()
        for line in log.splitlines():
            if any(n in line for n in NOTES):
                print(f"{Path(path).name}:", line.strip()[:200])
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {path}")
        lib = ctypes.CDLL(str(out))
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        if hasattr(lib, "scoring_variant"):
            lib.scoring_variant.argtypes = [p, p, p, p, i64, i64, i64, i32, i32, p]
            lib.scoring_variant.restype = i32
        else:  # an older source: one kernel for every shape
            lib.scoring.argtypes = [p, p, p, i64, i64, i64, p]
        lib.scoring.restype = i32
        libs[Path(path).name] = lib
    return libs


def run_older(lib: ctypes.CDLL, q, c):
    out = torch.empty(q.shape[0], c.shape[0], device=q.device)
    status = lib.scoring(q.data_ptr(), c.data_ptr(), out.data_ptr(), q.shape[0], c.shape[0], q.shape[1],
                         torch.cuda.current_stream().cuda_stream)
    _build.check(status, "older source")
    return out


def run_variant(lib: ctypes.CDLL, q, c, path: str, width: int):
    b, d = q.shape
    out = torch.empty(b, c.shape[0], device=q.device)
    scratch = torch.empty(2, b, d, device=q.device) if path == "tc" else None
    status = lib.scoring_variant(q.data_ptr(), c.data_ptr(), out.data_ptr(),
                                 None if scratch is None else scratch.data_ptr(), b, c.shape[0], d,
                                 int(path == "tc"), width, torch.cuda.current_stream().cuda_stream)
    _build.check(status, "variant")
    return out


def time_ms(fn, per_batch: int = 20, batches: int = 5) -> float:
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


def main() -> int:
    if not torch.cuda.is_available():
        print("scoring_ab: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    libs = build_variants(sys.argv[1:])
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    c = torch.randn(N, D, device=dev, generator=g)
    c /= c.norm(dim=-1, keepdim=True)
    stream_wins = []  # (B, whether the streaming kernel was faster)
    for b in BATCHES:
        q = torch.randn(b, D, device=dev, generator=g)
        q /= q.norm(dim=-1, keepdim=True)
        want = scoring_plain(q, c)
        variants = {"tc": pow2_at_least(b, 8, 128)}
        if b <= 64:
            variants["stream"] = pow2_at_least(b, 1, 16)
        if b >= 128:
            variants["tc64"] = 64
        row = {}
        for name, width in variants.items():
            path = "tc" if name.startswith("tc") else "stream"
            got = _scoring_variant(q, c, path, width)
            err = float((got - want).abs().max())
            torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
            del got
            row[name] = {"width": width, "ms": time_ms(lambda: _scoring_variant(q, c, path, width)),
                         "max_abs_err": err}
            for vname, lib in libs.items():
                if not hasattr(lib, "scoring_variant"):
                    continue
                got = run_variant(lib, q, c, path, width)
                row[name][vname] = {"ms": time_ms(lambda: run_variant(lib, q, c, path, width)),
                                    "max_abs_err": float((got - want).abs().max())}
                del got
                row[name]["tree_again_ms"] = time_ms(lambda: _scoring_variant(q, c, path, width))
        row["dispatch"] = {"path": _scoring_path(b, D), "ms": time_ms(lambda: scoring_cuda(q, c))}
        for vname, lib in libs.items():
            if hasattr(lib, "scoring_variant"):
                continue
            got = run_older(lib, q, c)
            row[vname] = {"ms": time_ms(lambda: run_older(lib, q, c)), "max_abs_err": float((got - want).abs().max())}
            del got
            row["dispatch"]["again_ms"] = time_ms(lambda: scoring_cuda(q, c))
        row["library"] = {"ms": time_ms(lambda: torch.matmul(q, c.T))}
        del want
        if "stream" in row:
            stream_wins.append((b, row["stream"]["ms"] < row["tc"]["ms"]))
        print(json.dumps({f"B={b}": row}), flush=True)
    crossover = 0
    for b, wins in stream_wins:  # the last B of the leading run of wins
        if not wins:
            break
        crossover = b
    print(json.dumps({"stream_faster_up_to_B": crossover}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
