"""A throwaway checkout for the benchmark's CPU tests: ``BENCHMARK.json``
and ``graphbench/`` copied into a temporary directory, the program linked
in, and tiny configurations of the benchmark's own graphs added beside the
real ones, each a new file and a new entry, as a later change would add
them, with a traffic mix of degree counts (``dc16``) as a new file too."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]
TINY = {  # configuration -> the real one it shrinks, and how
    "tiny-rmat": ("graph500-s22", {"scale": 10}),
    "tiny-grid": ("grid2d-1401", {"side": 40}),
}
DC16 = {"name": "dc16", "sessions": [{"count": 16, "query": {"kind": "degree_count"}}],
        "engine_config": {"steal": True}}
TRAFFIC = ("pr16", "bfs16", "dc16")


def tiny_checkout(tmp: Path) -> Path:
    root = tmp / "checkout"
    root.mkdir()
    shutil.copy(REPO / "BENCHMARK.json", root)
    shutil.copytree(REPO / "graphbench", root / "graphbench", ignore=shutil.ignore_patterns("tests", "__pycache__"))
    (root / "src").symlink_to(REPO / "src")
    (root / "graphbench" / "traffic" / "dc16.json").write_text(json.dumps(DC16))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for name, (real, cut) in TINY.items():
        conf = json.loads((root / "graphbench" / "configs" / f"{real}.json").read_text())
        conf["name"], conf["reduced"] = name, sorted(cut)
        conf["graph"].update(cut)
        (root / "graphbench" / "configs" / f"{name}.json").write_text(json.dumps(conf))
        bench["configs"].append({"name": name, "source": "test", "file": f"graphbench/configs/{name}.json",
                                 "reduced": sorted(cut), "why": "test"})
        for traffic in TRAFFIC:
            bench["workloads"].append({"name": f"{name}.{traffic}", "config": name, "traffic": traffic,
                                       "chips": 1, "why": "test"})
    tiny = [w["name"] for w in bench["workloads"] if w["name"].startswith("tiny-")]
    for m in bench["end_to_end"] + bench["per_layer"]:  # every metric in every tiny cell too
        if "workloads" in m:
            m["workloads"] = m["workloads"] + tiny
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run(root: Path, workload: str, seed: int = 2**31 + 7, seconds: float = 0.05, trace: bool = False,
        device: str = "cpu") -> dict:
    from graphbench import harness

    return harness.run_cell(root, workload, seed, seconds, trace, torch.device(device), lambda msg: None)
