#!/usr/bin/env python3
"""Read the control of a cell: the plain reference put in the program's
place, in the precision below the configuration's (or with one of its
guarantees broken), judged by the cell's own comparison.

    python3 graphbench/control.py --workload grid-pr16 --seeds 11 12 13

For each seed it draws the cell's graph at its full size, answers every
distinct query of ``--rounds`` rounds of the cell's traffic both ways, and
prints one JSON line: each compared number and its limit. A sound
comparison sees every control fail one of them. The benchmark's runs do
not run this; it touches nothing of the program.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control_readings(root: Path, workload: str, seed: int, rounds: int, device) -> dict:
    """The worst reading of each compared number over the control's answers."""
    from graphbench import harness
    from graphbench.reference import GraphRef

    cell = harness.find_cell(root, workload)
    groups = cell.traffic["sessions"]
    kinds = [harness.load_module(root, "queries", g["query"]["kind"]) for g in groups]
    gen = harness.load_module(root, "generators", cell.config["generator"])
    src, dst, v = gen.generate(cell.config["graph"], seed, device)
    edges = (src.cpu().numpy(), dst.cpu().numpy(), v)
    ref = GraphRef(src, dst, v)
    checks = harness.Checks()
    for kind, group in zip(kinds, groups):
        insts = kind.instances(dict(group["query"], count=int(group["count"])), edges, seed)
        for inst in insts[: rounds * int(group["count"])]:
            checks.add(kind, kind.compare(kind.control(ref, inst), kind.expected(ref, inst)))
    return checks.readings


def main(argv: list[str] | None = None) -> int:
    import torch

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--rounds", type=int, default=4)
    args = p.parse_args(argv)
    device = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    for seed in args.seeds:
        t0 = time.perf_counter()
        got = control_readings(ROOT, args.workload, seed, args.rounds, device)
        failed = any(c["value"] > c["limit"] for c in got.values())
        print(json.dumps({"workload": args.workload, "seed": seed, "device": str(device),
                          "control_fails": failed, "readings": got,
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)
    sys.exit(main())
