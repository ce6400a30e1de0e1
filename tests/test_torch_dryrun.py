"""The port's dry-run (``repro_torch.launch.dryrun``) and the paper's own
graph-engine cells against the JAX package.

The reference's ``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host
devices when imported, so it is imported only in a subprocess here, where
its ``run_cell`` builds a record around a stub lowering (no compile) to
give the reference's record keys. The graph-engine steps run on RMAT
scale 10 (seed 3) with both packages' ``V``/``E`` set to the graph's."""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

ROOT = pathlib.Path(__file__).resolve().parents[1]

# the reference's PageRank tolerances (tests/test_algorithms.py): float32
# sums of the same terms in another order (segment_sum vs index_add_)
PR_RTOL, PR_ATOL = 2e-4, 1e-8

_REFERENCE_RECORD = r"""
import json, sys, types
import repro.launch.dryrun as dr
import repro.launch.mesh as mesh_mod
import repro.launch.steps as steps
from jax.sharding import AbstractMesh

class Compiled:
    def memory_analysis(self):
        return types.SimpleNamespace(argument_size_in_bytes=1, output_size_in_bytes=2, temp_size_in_bytes=3)
    def cost_analysis(self):
        return {"flops": 4.0, "bytes accessed": 5.0}
    def as_text(self):
        return ""

class Lowered:
    def compile(self):
        return Compiled()

mesh_mod.make_production_mesh = lambda multi_pod=False: AbstractMesh((16, 16), ("data", "model"))
steps.CellProgram.lower = lambda self, mesh, rules=None: Lowered()
rec = dr.run_cell(sys.argv[1], sys.argv[2], "single", analysis=True)
rec["scaled"] = dr.scaled_totals(rec, 3)
print(json.dumps(rec))
"""


def _keys(d: dict, prefix: str = "") -> set[str]:
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict) and k not in ("meta", "collectives"):  # collectives: None in the port
            out |= _keys(v, prefix + k + ".")
    return out


def _reference_record(arch: str, shape: str) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _REFERENCE_RECORD, arch, shape], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch,shape", [("schnet", "molecule"), ("tinyllama-1.1b", "decode_32k")])
def test_record_has_the_reference_keys(arch, shape):
    """The reference's keys, each at its place, plus the port's own: the
    FLOP count under its own name and the whole-program byte totals. The
    keys with no counterpart without XLA are None; meta is the reference's."""
    from repro_torch.launch.dryrun import run_cell, scaled_totals

    ref = _reference_record(arch, shape)
    rec = run_cell(arch, shape, "single", analysis=True)
    rec["scaled"] = scaled_totals(rec, 3)
    extra = {"flop_counter_flops", "memory.argument_bytes_total", "memory.output_bytes_total"}
    without_xla = ("compile_s", "hlo_flops", "hlo_bytes", "collectives", "hlo_chars")
    for part in ("full", "trip1", "trip2"):
        assert _keys(rec[part]) == _keys(ref[part]) | extra
        assert {k: rec[part][k] for k in without_xla} == dict.fromkeys(without_xla)
        assert rec[part]["memory"]["temp_bytes"] is None and rec[part]["memory"]["output_bytes"] is None
    assert _keys(rec) == _keys(ref) | {f"{p}.{k}" for p in ("full", "trip1", "trip2") for k in extra} | {
        "scaled.flop_counter_flops_scaled"}
    assert rec["meta"] == ref["meta"]
    assert {k: rec[k] for k in ("arch", "shape", "mesh", "chips", "cell", "kind", "variant")} == {
        k: ref[k] for k in ("arch", "shape", "mesh", "chips", "cell", "kind", "variant")}
    assert set(rec["scaled"]) == set(ref["scaled"]) | {"flop_counter_flops_scaled"}


@pytest.mark.parametrize("arch,shape", [("tinyllama-1.1b", "prefill_32k"), ("pna", "molecule"),
                                        ("schnet", "molecule"), ("graphcast", "full_graph_sm")])
def test_full_depth_flops_equal_the_trip_scaled_flops(arch, shape):
    from repro_torch.launch.dryrun import full_depth, run_cell, scaled_totals

    rec = run_cell(arch, shape, "single", analysis=True)
    n = full_depth(arch, shape)
    scaled = scaled_totals(rec, n)
    full = rec["full"]["flop_counter_flops"]
    assert isinstance(full, int) and full > 0
    assert scaled["flop_counter_flops_scaled"] == full
    assert rec["trip2"]["flop_counter_flops"] > rec["trip1"]["flop_counter_flops"]
    assert scaled["flops_scaled"] is None and scaled["collective_bytes_scaled"] is None


def test_moe_trips_at_one_microbatch_overstate_the_dense_dispatch():
    """The reference's trips run one microbatch. GShard's dense dispatch
    costs T·E·C·D with the capacity C proportional to the T tokens of a
    microbatch, so one microbatch of all the tokens costs the microbatch
    count times more than the cell's microbatches: the extrapolation
    exceeds the full depth's count. Trips at the cell's own microbatch
    count extrapolate to it exactly (two layers, four microbatches of
    ``train_4k``, on the smoke config's narrow widths)."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.configs.lm_common import lm_cell
    from repro_torch.launch.dryrun import scaled_totals
    from repro_torch.launch.mesh import make_production_mesh

    mesh = make_production_mesh()
    base = dataclasses.replace(get_arch("grok-1-314b").make_smoke_config(), microbatches=4)

    def flops(**kw) -> int:
        return lm_cell(base, "train_4k", "adafactor", **kw).lower(mesh).flops

    full = flops()
    own = {"trip1": {"flop_counter_flops": flops(n_layers_override=1)},
           "trip2": {"flop_counter_flops": flops(n_layers_override=2)}}
    one = {"trip1": {"flop_counter_flops": flops(n_layers_override=1, microbatches_override=1)},
           "trip2": {"flop_counter_flops": flops(n_layers_override=2, microbatches_override=1)}}
    assert scaled_totals(own, 2)["flop_counter_flops_scaled"] == full
    assert scaled_totals(one, 2)["flop_counter_flops_scaled"] > full
    dense = dataclasses.replace(base, moe=None)
    full_dense = lm_cell(dense, "train_4k", "adafactor").lower(mesh).flops
    assert lm_cell(dense, "train_4k", "adafactor", microbatches_override=1).lower(mesh).flops == full_dense


def test_flop_count_equals_flop_counter_mode():
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_production_mesh

    for arch, shape in (("tinyllama-1.1b", "train_4k"), ("meshgraphnet", "molecule"),
                        ("two-tower-retrieval", "serve_p99")):
        mod = get_arch(arch)
        cell = mod.make_cell(shape, n_layers_override=1, microbatches_override=1)
        got = cell.lower(make_production_mesh()).flops
        with FlopCounterMode(display=False) as counter:
            cell.step_fn(*cell.abstract_args)
        assert got == counter.get_total_flops() > 0


def test_argument_bytes_per_chip_follow_the_plan():
    from repro_torch.configs import get_arch
    from repro_torch.launch.dryrun import run_cell

    mod = get_arch("paper-graph-engine")
    rec = run_cell("paper-graph-engine", "pr_iteration", "single", analysis=True)
    mem = rec["full"]["memory"]
    whole = 4 * (2 * mod.E + 2 * mod.V)  # every leaf over the flat 256 chips
    assert (mem["argument_bytes_total"], mem["argument_bytes"], mem["output_bytes_total"]) == (
        whole, whole // 256, 4 * mod.V)
    assert "trip1" not in rec and rec["kind"] == "serve" and rec["chips"] == 256
    decode = run_cell("granite-34b", "long_500k", "multi", analysis=False)
    # batch 1 takes cache_seq over ('data', 'model'); the single KV head replicates
    assert decode["chips"] == 512 and decode["meta"]["kv_bytes"] == 2 * 88 * 524288 * 128 * 2


def test_single_writes_its_json(tmp_path, capsys):
    from repro_torch.launch.dryrun import main

    main(["--single", "--arch", "pna", "--shape", "molecule", "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "pna__molecule__single.json").read_text())
    assert rec["n_layers_full"] == 4 and rec["cell"] == "pna:molecule"
    assert rec["scaled"]["flop_counter_flops_scaled"] == rec["full"]["flop_counter_flops"]
    assert json.loads(capsys.readouterr().out.splitlines()[0])["cell"] == "pna:molecule"
    main(["--single", "--arch", "grok-1-314b", "--shape", "decode_32k", "--variant", "gather",
          "--no-analysis", "--mesh", "multi", "--out", str(tmp_path)])
    rec = json.loads((tmp_path / "grok-1-314b__decode_32k__multi__gather.json").read_text())
    assert rec["variant"] == "gather" and "trip1" not in rec and "scaled" not in rec


# ---------------------------------------------------------------------------
# the kernels' meta branches
# ---------------------------------------------------------------------------

def test_meta_branches_give_the_plain_versions_shapes():
    from repro_torch.kernels.attention.ops import flash_attention_gqa
    from repro_torch.kernels.degree_count.ops import count_into
    from repro_torch.kernels.embedding_bag.ops import embedding_bag
    from repro_torch.kernels.scoring.ops import score_topk
    from repro_torch.kernels.spmv.ops import build_tiles, spmv, spmv_tiles

    g = torch.Generator().manual_seed(0)
    q, k, v = torch.randn(2, 64, 4, 16, generator=g), torch.randn(2, 64, 2, 16, generator=g), torch.randn(
        2, 64, 2, 16, generator=g)
    table, ids = torch.randn(50, 8, generator=g), torch.randint(0, 50, (30,), generator=g)
    segs = torch.sort(torch.randint(0, 7, (30,), generator=g)).values
    cands, queries = torch.randn(700, 8, generator=g), torch.randn(3, 8, generator=g)
    src, dst = torch.randint(0, 900, (5000,), generator=g), torch.randint(0, 900, (5000,), generator=g)
    tables, contrib = build_tiles(src, dst, 900), torch.rand(900, generator=g)

    def meta(t):
        return t.to("meta")

    cases = [
        (flash_attention_gqa(q, k, v, block_kv=16), flash_attention_gqa(meta(q), meta(k), meta(v), block_kv=16)),
        (embedding_bag(table, ids, segs, 9), embedding_bag(meta(table), meta(ids), meta(segs), 9)),
        (count_into(src, torch.zeros(900, dtype=torch.int32)), count_into(meta(src), torch.zeros(
            900, dtype=torch.int32, device="meta"))),
        (spmv(tables, contrib), spmv(tables, meta(contrib))),
        (spmv_tiles(tables, contrib, 0, 1), spmv_tiles(tables, meta(contrib), 0, 1)),
    ]
    cases += list(zip(score_topk(queries, cands, 16), score_topk(meta(queries), meta(cands), 16)))
    for cpu, on_meta in cases:
        assert on_meta.device.type == "meta"
        assert (on_meta.shape, on_meta.dtype) == (cpu.shape, cpu.dtype)
    # the attention's gradient path: the meta forward, the plain backward
    qm = meta(q).requires_grad_()
    flash_attention_gqa(qm, meta(k), meta(v), block_kv=16).sum().backward()
    assert qm.grad.shape == q.shape and qm.grad.device.type == "meta"


def test_meta_branches_count_the_plain_versions_flops():
    """The flash and scoring entries run their plain versions on ``meta``,
    so a trace counts the same products as on the CPU: the attention's
    forward as well as its plain backward (exactly equal counts)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels.attention.ops import flash_attention_gqa
    from repro_torch.kernels.scoring.ops import score_topk

    g = torch.Generator().manual_seed(0)
    q, k, v = torch.randn(2, 64, 4, 16, generator=g), torch.randn(2, 64, 2, 16, generator=g), torch.randn(
        2, 64, 2, 16, generator=g)
    cands, queries = torch.randn(700, 8, generator=g), torch.randn(3, 8, generator=g)

    def counted(dev, grad: bool) -> tuple[int, int]:
        qq = q.to(dev, copy=True).requires_grad_(grad)
        with FlopCounterMode(display=False) as fwd:
            out = flash_attention_gqa(qq, k.to(dev), v.to(dev), block_kv=16)
            score_topk(queries.to(dev), cands.to(dev), 16)
        with FlopCounterMode(display=False) as bwd:
            if grad:
                out.sum().backward()
        return fwd.get_total_flops(), bwd.get_total_flops()

    for grad in (False, True):
        cpu, on_meta = counted("cpu", grad), counted("meta", grad)
        assert on_meta == cpu and cpu[0] > 0 and (cpu[1] > 0) == grad


# ---------------------------------------------------------------------------
# paper-graph-engine on RMAT scale 10
# ---------------------------------------------------------------------------

@pytest.fixture
def engine(monkeypatch, small_rmat):
    import repro.configs.paper_graph_engine as jax_engine

    import repro_torch.configs.paper_graph_engine as engine

    v, e = small_rmat.num_vertices, small_rmat.num_edges
    for mod in (engine, jax_engine):
        monkeypatch.setattr(mod, "V", v)
        monkeypatch.setattr(mod, "E", e)
    return engine, jax_engine, small_rmat


def test_graph_engine_pr_iteration_equals_the_reference(engine):
    import jax.numpy as jnp

    mod, jmod, g = engine
    src, dst = np.array(g.src, np.int32), np.array(g.dst, np.int32)
    v = g.num_vertices
    rng = np.random.default_rng(3)
    rank = rng.random(v).astype(np.float32)
    rank /= rank.sum()
    out_deg = np.bincount(src, minlength=v).astype(np.int32)
    got = mod.make_cell("pr_iteration").step_fn(*map(torch.from_numpy, (src, dst, rank, out_deg)))
    want = jmod.make_cell("pr_iteration").step_fn(*map(jnp.asarray, (src, dst, rank, out_deg)))
    assert got.dtype == torch.float32 and got.shape == (v,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=PR_RTOL, atol=PR_ATOL)


def test_graph_engine_bfs_expand_equals_the_reference_to_its_fixed_point(engine):
    """Each level's (visited, new) equal to the reference's step's, and the
    levels at the fixed point equal to ``bfs_reference``'s (the one-device
    counterpart of the reference's sharded BFS parity test)."""
    import jax.numpy as jnp
    from repro.algorithms import bfs_reference

    mod, jmod, g = engine
    v = g.num_vertices
    src, dst = np.array(g.src, np.int32), np.array(g.dst, np.int32)
    step, jstep = mod.make_cell("bfs_expand").step_fn, jmod.make_cell("bfs_expand").step_fn
    source = int(np.argmax(np.bincount(src, minlength=v)))
    visited = np.zeros(v, bool)
    visited[source] = True
    frontier = visited.copy()
    level = np.full(v, -1, np.int32)
    level[source] = 0
    ts, td = torch.from_numpy(src), torch.from_numpy(dst)
    js, jd = jnp.asarray(src), jnp.asarray(dst)
    depth = 0
    while frontier.any():
        depth += 1
        got_vis, got_new = step(ts, td, torch.from_numpy(visited), torch.from_numpy(frontier))
        want_vis, want_new = jstep(js, jd, jnp.asarray(visited), jnp.asarray(frontier))
        assert np.array_equal(got_vis.numpy(), np.asarray(want_vis))
        assert np.array_equal(got_new.numpy(), np.asarray(want_new))
        visited, frontier = got_vis.numpy(), got_new.numpy()
        level[frontier] = depth
    assert depth > 2
    np.testing.assert_array_equal(level, bfs_reference(g, source))


def test_graph_engine_steps_keep_the_reference_id_rules(monkeypatch):
    """Ids outside [0, V): ``jnp.take`` wraps [-V, 0) and fills NaN (True
    for a boolean frontier) past either end; ``segment_sum`` drops every
    target outside [0, V); ``.at[dst].max(mode="drop")`` wraps [-V, 0) and
    drops the rest."""
    import jax.numpy as jnp
    import repro.configs.paper_graph_engine as jax_engine

    import repro_torch.configs.paper_graph_engine as engine

    v = 6
    for mod in (engine, jax_engine):
        monkeypatch.setattr(mod, "V", v)
        monkeypatch.setattr(mod, "E", 8)
    src = np.array([0, 1, -1, 7, -7, 2, 5, 3], np.int32)
    dst = np.array([1, -1, 2, 3, 4, 9, -6, -7], np.int32)
    rank = np.linspace(0.1, 0.6, v).astype(np.float32)
    out_deg = np.array([1, 0, 2, 1, 0, 3], np.int32)
    got = engine.pr_step(*map(torch.from_numpy, (src, dst, rank, out_deg)))
    want = jax_engine.make_cell("pr_iteration").step_fn(*map(jnp.asarray, (src, dst, rank, out_deg)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for frontier in (np.array([1, 0, 0, 0, 0, 1], bool), np.zeros(v, bool)):
        visited = np.array([0, 0, 0, 1, 0, 0], bool)
        got = engine.bfs_step(*map(torch.from_numpy, (src, dst, visited, frontier)))
        want = jax_engine.make_cell("bfs_expand").step_fn(*map(jnp.asarray, (src, dst, visited, frontier)))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
