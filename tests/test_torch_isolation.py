"""The port stands alone: importing every module of ``repro_torch`` (and the
chip smoke script) loads neither JAX nor the JAX package, and its entry
points refuse to run silently on the CPU when no card is present."""
import os
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
names = ["repro_torch"]
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
    names.append(m.name)
import chip_smoke  # module only: main() is not run on import
leaked = sorted(n for n in sys.modules if n in ("jax", "repro") or n.startswith(("jax.", "repro.")))
assert not leaked, leaked
print(len(names))
"""


def test_port_imports_neither_jax_nor_reference_package():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"), str(ROOT)]))
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=240,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20  # every module was walked


def test_entry_points_refuse_cpu_without_explicit_device(monkeypatch):
    from repro_torch.graph import build_graph, resolve_device, rmat_graph

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_graph([0, 1], [1, 0], 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rmat_graph(4, seed=0)
    assert resolve_device("cpu") == torch.device("cpu")
    assert build_graph([0, 1], [1, 0], 2, device="cpu").device.type == "cpu"
