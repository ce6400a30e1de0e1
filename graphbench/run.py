#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once on the card and print its result.

    python3 graphbench/run.py --workload grid-pr16 --seed 7 --seconds 30 --trace 0

Run from the root of a checkout. The last line of standard output is the
result (JSON); the numbers compared against the plain reference, each with
its limit, are the last lines of standard error. The exit code is not 0,
and no result is printed, where there is no CUDA device, where the program
is missing, or where JAX or the JAX package got loaded.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv: list[str] | None = None) -> int:
    from graphbench import harness

    t_process = harness.process_start_epoch()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        log("no CUDA device: the benchmark measures the card only")
        return 2
    cell = harness.find_cell(ROOT, args.workload)
    if torch.cuda.device_count() < int(cell.workload["chips"]):
        log(f"{args.workload} needs {cell.workload['chips']} cards, {torch.cuda.device_count()} found")
        return 2
    line = harness.run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                            torch.device("cuda", 0), log, t_process=t_process)
    bad = harness.forbidden_modules()
    if bad:
        log(f"forbidden modules loaded: {bad}")
        return 3
    print(json.dumps(line), flush=True)
    for name, c in line["checks"].items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)  # the checkout's root, not this folder: graphbench is a package
    sys.exit(main())
