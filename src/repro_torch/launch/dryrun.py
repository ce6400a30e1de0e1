"""Dry-run of every (arch × shape) cell on a production mesh plan (the
reference's ``repro.launch.dryrun``), on one host with no device:

    python -m repro_torch.launch.dryrun --single --arch tinyllama-1.1b --shape prefill_32k
    python -m repro_torch.launch.dryrun --all --out artifacts/dryrun_torch

A cell is planned (each argument leaf's spec under the mesh's rules) and
lowered: its step runs on ``meta`` tensors (``CellProgram.lower``), which
gives its outputs' shapes and its FLOPs. A record has the reference's keys;
those with no counterpart without XLA are ``None``: ``compile_s``,
``memory.temp_bytes``, ``hlo_flops``, ``hlo_bytes``, ``collectives`` (the
reference parses the collectives out of the partitioned HLO; one device has
none to parse, and the port does not emulate them) and ``hlo_chars``, and
``memory.output_bytes`` (per chip: the partitioner chooses the outputs'
shardings). ``memory.argument_bytes`` is per chip under the plan: each
leaf's bytes over the product of its spec's axis sizes.
``memory.argument_bytes_total`` and ``output_bytes_total`` are the whole
program's. ``flop_counter_flops`` is the port's FLOP count:
``torch.utils.flop_counter``'s formulas over the whole program (its
matmul-family ops, each kernel's forward left out), not XLA's
``hlo_flops`` (every op, per device).

With analysis, train/prefill/decode cells (not the two-tower model's) are
also lowered at depth 1 and 2 (``trip1``/``trip2``, one microbatch), and
``scaled_totals`` extrapolates a fixed part plus a per-layer part to the
full depth, as the reference does. The meta trace runs every layer and
microbatch, so the full depth's ``flop_counter_flops`` must equal the
extrapolation exactly (integers), a check the reference cannot make.

Importing this module has no side effects."""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

from .._tree import tree_leaves, tree_paths

# the reference's meshes and the local one (the card: ``make_local_mesh``)
MESH_KINDS = ("single", "multi", "local")


def _mesh(mesh_kind: str):
    from .mesh import make_local_mesh, make_production_mesh

    if mesh_kind == "local":
        return make_local_mesh()
    return make_production_mesh(multi_pod=(mesh_kind == "multi"))


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _leaves(tree) -> list:
    return tree_leaves(list(tree) if isinstance(tree, tuple) else tree)


def per_chip_bytes(cell, mesh, rules) -> int:
    """The arguments' bytes on one chip under the plan: each leaf's bytes
    over the product of its spec's mesh-axis sizes."""
    total = 0
    for tree, specs in zip(cell.trees(), cell.shardings(mesh, rules)):
        for (_, leaf), (_, spec) in zip(tree_paths(tree), tree_paths(specs)):
            axes = [a for part in spec if part is not None for a in (part if isinstance(part, tuple) else (part,))]
            total += _nbytes(leaf) // math.prod(mesh.shape[a] for a in axes)
    return total


def analyze_lowered(lowered, cell, mesh, rules) -> dict:
    return {
        "compile_s": None,
        "memory": {
            "argument_bytes": per_chip_bytes(cell, mesh, rules),
            "output_bytes": None,
            "temp_bytes": None,
            "argument_bytes_total": sum(_nbytes(t) for t in _leaves(cell.trees())),
            "output_bytes_total": sum(_nbytes(t) for t in _leaves(lowered.out)),
        },
        "hlo_flops": None,
        "hlo_bytes": None,
        "collectives": None,
        "hlo_chars": None,
        "flop_counter_flops": lowered.flops,
    }


def run_cell(arch: str, shape: str, mesh_kind: str, *, analysis: bool, variant: str | None = None) -> dict:
    """Worker: plan and lower one cell (optionally plus trip-1/2 analysis)."""
    from ..configs import get_arch
    from ..sharding.context import unrolled_scans
    from ..sharding.rules import default_rules

    mod = get_arch(arch)
    mesh = _mesh(mesh_kind)
    chips = mesh.size

    kwargs = {}
    if variant == "blocked":
        kwargs["blocked"] = True
    elif variant == "seqpar":
        kwargs["seq_parallel"] = True
    elif variant:
        kwargs["dispatch"] = variant
    cell = mod.make_cell(shape, **kwargs)
    rules = default_rules(mesh)
    rules.update(cell.meta.get("rules_override", {}))

    record: dict = {
        "arch": arch,
        "shape": shape,
        "mesh": mesh_kind,
        "chips": chips,
        "cell": cell.name,
        "kind": cell.kind,
        "variant": variant or "baseline",
        "meta": {k: v for k, v in cell.meta.items() if not isinstance(v, dict)},
    }

    t0 = time.time()
    lowered = cell.lower(mesh, rules)
    record["lower_s"] = round(time.time() - t0, 2)
    record["full"] = analyze_lowered(lowered, cell, mesh, rules)

    if analysis and cell.kind in ("train", "prefill", "decode") and arch != "two-tower-retrieval":
        # trip-1 / trip-2 variants for exact per-layer scaling
        trips = {}
        for n_l in (1, 2):
            try:
                c = mod.make_cell(
                    shape, n_layers_override=n_l, microbatches_override=1, **kwargs
                )
            except TypeError:
                c = mod.make_cell(shape, n_layers_override=n_l, **kwargs)
            with unrolled_scans():
                lw = c.lower(mesh, rules)
            trips[n_l] = analyze_lowered(lw, c, mesh, rules)
        record["trip1"] = trips[1]
        record["trip2"] = trips[2]

    return record


def scaled_totals(record: dict, n_layers_full: int) -> dict:
    """fixed + per-layer × L scaling from the trip-1/2 lowerings (``None``
    where the trips have no number)."""
    t1, t2 = record.get("trip1"), record.get("trip2")
    if not t1 or not t2:
        return {}

    def scale(key, sub=None):
        a, b = (t.get(key) if sub is None else (t.get(key) or {}).get(sub) for t in (t1, t2))
        if a is None or b is None:
            return None
        per_layer = max(b - a, 0)
        fixed = max(a - per_layer, 0)
        return fixed + per_layer * n_layers_full

    return {
        "flops_scaled": scale("hlo_flops"),
        "bytes_scaled": scale("hlo_bytes"),
        "collective_bytes_scaled": scale("collectives", "total_weighted_bytes"),
        "flop_counter_flops_scaled": scale("flop_counter_flops"),
    }


def full_depth(arch: str, shape: str) -> int:
    """The number of layers the trips extrapolate to: the config's
    ``n_layers`` (``n_interactions`` for SchNet)."""
    from ..configs import get_arch

    mod = get_arch(arch)
    try:
        cfg = mod.make_config(shape)
    except TypeError:
        cfg = mod.make_config()
    return getattr(cfg, "n_layers", getattr(cfg, "n_interactions", 1))


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description="multi-pod dry-run (a plan and a meta trace)")
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", choices=list(MESH_KINDS), default="single")
    ap.add_argument("--variant", default=None, help="e.g. MoE dispatch=gather")
    ap.add_argument("--single", action="store_true", help="worker mode: run one cell in-process")
    ap.add_argument("--all", action="store_true", help="sweep all cells, each in a subprocess")
    ap.add_argument("--meshes", default="single,multi")
    ap.add_argument("--no-analysis", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun")
    args = ap.parse_args(argv)

    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)

    if args.single:
        rec = run_cell(
            args.arch, args.shape, args.mesh,
            analysis=not args.no_analysis, variant=args.variant,
        )
        # attach layer scaling if trips were run
        if "trip1" in rec:
            n_l = full_depth(args.arch, args.shape)
            rec["scaled"] = scaled_totals(rec, n_l)
            rec["n_layers_full"] = n_l
        tag = f"{args.arch}__{args.shape}__{args.mesh}"
        if args.variant:
            tag += f"__{args.variant}"
        path = outdir / (tag.replace("/", "_") + ".json")
        path.write_text(json.dumps(rec, indent=1))
        print(json.dumps({k: rec[k] for k in ("cell", "mesh", "lower_s")}, indent=None))
        print(f"wrote {path}")
        return

    if args.all:
        from ..configs import all_cells

        cells = all_cells()
        meshes = args.meshes.split(",")
        todo = [(a, s, m) for a, s in cells for m in meshes]
        print(f"dry-run sweep: {len(todo)} runs -> {outdir}")
        failures = []
        for i, (a, s, m) in enumerate(todo):
            tag = f"{a}__{s}__{m}".replace("/", "_")
            path = outdir / (tag + ".json")
            if path.exists():
                print(f"[{i+1}/{len(todo)}] {tag} (cached)")
                continue
            cmd = [
                sys.executable, "-m", "repro_torch.launch.dryrun", "--single",
                "--arch", a, "--shape", s, "--mesh", m, "--out", str(outdir),
            ]
            if m == "multi" or args.no_analysis:
                cmd.append("--no-analysis")  # analysis on single-pod only
            t0 = time.time()
            r = subprocess.run(cmd, capture_output=True, text=True)
            dur = time.time() - t0
            ok = r.returncode == 0 and path.exists()
            print(f"[{i+1}/{len(todo)}] {tag}: {'OK' if ok else 'FAIL'} ({dur:.0f}s)")
            if not ok:
                failures.append(tag)
                (outdir / (tag + ".err")).write_text(
                    r.stdout[-4000:] + "\n---\n" + r.stderr[-8000:]
                )
        print(f"done; {len(failures)} failures: {failures}")
        sys.exit(1 if failures else 0)

    ap.error("pass --single or --all")


if __name__ == "__main__":
    main()
