"""Build the port's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exports plain C launch functions (no PyTorch
headers, so a build takes seconds). It is compiled at first use into
``build/repro_torch/lib<name>-<hash>.so`` beside the checkout, where the hash
covers the source and the flags, so an edited source is rebuilt and an
unchanged one is reused. :func:`build` starts one ``nvcc`` per source, all at
once, and waits for them together. Any failure raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parents[1] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills per kernel, in the log
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# name -> nvcc's report for the build made in this process (ptxas -v lines)
build_log: dict[str, str] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on
    the PATH."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on the PATH")
    return found


def library_path(name: str) -> Path:
    """Where the shared library built from ``csrc/<name>.cu`` lives."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(*names: str) -> dict[str, float]:
    """Compile the named sources that are not built yet, in parallel.
    Returns the wall seconds each build took (0.0 for a library reused)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = None
    started: dict[str, tuple[subprocess.Popen, Path, Path, float]] = {}
    seconds: dict[str, float] = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        compiler = compiler or nvcc()
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        started[name] = (proc, tmp, out, time.perf_counter())
    failures = []
    for name, (proc, tmp, out, t0) in started.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        build_log[name] = log
        if proc.returncode != 0:
            failures.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first if
    needed (once per process)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build(name)
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib


def check(status: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")
