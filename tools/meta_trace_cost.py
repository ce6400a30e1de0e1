#!/usr/bin/env python3
"""What the dry-run's meta trace costs with and without ``_MetaTrace``'s
output cache, at full depth, for the cells whose traces are the longest
(granite-34b's and grok-1's ``train_4k``).

    python3 tools/meta_trace_cost.py [arch:shape ...]

For each cell, one spawned process times ``CellProgram.lower`` on the
single-pod plan under ``launch.steps._MetaTrace`` (the cache) and one
under ``torch.utils.flop_counter.FlopCounterMode`` alone (no cache); all
run at once, one thread each, as ``chip_smoke.py``'s sweep runs its
workers. The two FLOP counts must be equal. Prints one JSON line and
writes it to ``chiprun_out/meta_trace_cost.json``. CPU only: the traces
are on the ``meta`` device.
"""
from __future__ import annotations

import concurrent.futures
import json
import multiprocessing
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

CELLS = ("granite-34b:train_4k", "grok-1-314b:train_4k")


def trace(cell: str, cached: bool) -> dict:
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_arch
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_production_mesh

    class Uncached(FlopCounterMode):
        """``FlopCounterMode`` with ``_MetaTrace``'s ``flops``."""

        def __init__(self):
            super().__init__(display=False)

        @property
        def flops(self) -> int:
            return self.get_total_flops()

    torch.set_num_threads(1)
    if not cached:
        steps._MetaTrace = Uncached
    arch, shape = cell.split(":")
    program = get_arch(arch).make_cell(shape)
    t0 = time.perf_counter()
    flops = program.lower(make_production_mesh()).flops
    return {"cell": cell, "cached": cached, "lower_s": time.perf_counter() - t0, "flops": flops}


def main(argv: list[str]) -> int:
    cells = argv or list(CELLS)
    jobs = [(c, cached) for c in cells for cached in (True, False)]
    with concurrent.futures.ProcessPoolExecutor(len(jobs), mp_context=multiprocessing.get_context("spawn")) as pool:
        rows = list(pool.map(trace, *zip(*jobs)))
    out = {"meta_trace_cost": {}}
    ok = True
    for c in cells:
        with_cache, without = (next(r for r in rows if r["cell"] == c and r["cached"] is k) for k in (True, False))
        ok &= with_cache["flops"] == without["flops"]
        out["meta_trace_cost"][c] = {"cached_s": with_cache["lower_s"], "uncached_s": without["lower_s"],
                                     "ratio": without["lower_s"] / with_cache["lower_s"],
                                     "flops": with_cache["flops"], "flops_equal": with_cache["flops"] == without["flops"]}
    line = json.dumps(out)
    print(line)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "meta_trace_cost.json").write_text(line + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
