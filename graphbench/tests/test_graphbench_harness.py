"""The harness at a tiny size on the CPU, with the kernels' plain versions:
set-up, rounds and the check against the plain reference; finding a new
configuration, traffic mix, generator and metric by name; the module check
and the refusal to run without a card."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from graphbench import harness
from graphbench_tiny import REPO, run, tiny_checkout


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return tiny_checkout(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("workload", ["tiny-rmat.pr16", "tiny-grid.pr16", "tiny-rmat.bfs16",
                                      "tiny-grid.bfs16", "tiny-rmat.dc16"])
def test_cell_matches_reference(checkout, workload):
    line = run(checkout, workload)
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 16 and line["attempted"] % 16 == 0
    assert line["failed"] == 0
    assert line["checks"]["queries_unstamped"]["value"] == 0  # fused and stolen queries stamped too
    assert set(line["metrics"]) == {"edges_per_s", "query_p50_ms", "query_p90_ms", "query_p95_ms", "setup_s"}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert list(line)[-1] == "checks"


def test_traced_run_reads_host_metrics(checkout):
    line = run(checkout, "tiny-rmat.bfs16", trace=True)
    assert line["correct"]
    # the device's metrics need the card's profile: left out here, never 0
    assert set(line["metrics"]) == {"engine_host_pct", "backend_step_ms", "launches_per_step", "graph_build_s"}
    assert 0 < line["metrics"]["engine_host_pct"]["value"] < 100


def test_work_is_the_benchmarks_own_count(checkout):
    """edges_per_s counts E per PageRank iteration: 5 iterations of the
    tiny RMAT graph's 16,384 edges a query."""
    line = run(checkout, "tiny-rmat.pr16", seconds=0.0)
    rate = line["metrics"]["edges_per_s"]["value"]
    assert line["attempted"] == 16
    window = 16 * 5 * 16384 / rate
    assert 0 < window < 60


def test_new_files_are_found_by_name(checkout, tmp_path):
    """A configuration, a generator, a traffic mix and a metric added as
    new files, with new entries in BENCHMARK.json, run without an edit to
    any existing file."""
    root = tiny_checkout(tmp_path)
    gb = root / "graphbench"
    (gb / "generators" / "ring.py").write_text(
        "import torch\n\n\ndef generate(params, seed, device):\n"
        "    n = int(params['n'])\n    a = torch.arange(n, device=device)\n"
        "    return torch.cat([a, (a + 1) % n]), torch.cat([(a + 1) % n, a]), n\n")
    (gb / "configs" / "ring-x.json").write_text(json.dumps({
        "name": "ring-x", "generator": "ring", "graph": {"n": 300}, "reduced": [],
        "engine": {"hardware": "XEON_E5_2660V4", "policy": "scheduler"}}))
    (gb / "traffic" / "mix3.json").write_text(json.dumps({"name": "mix3", "sessions": [
        {"count": 2, "query": {"kind": "pagerank_pull", "max_iters": 3, "tol": 0}},
        {"count": 1, "query": {"kind": "bfs", "roots": {"keys": 4, "min_out_degree": 1}}}],
        "pool_capacity": 8, "engine_config": {"steal": True, "fuse": True, "hetero_fuse": True,
                          "fusion": {"hold_ns": 5e4, "max_members": 4}}}))
    (gb / "metrics" / "rounds_seen.py").write_text(
        "def read(run):\n    return float(len({q.round for q in run.queries}))\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "ring-x", "source": "test", "file": "graphbench/configs/ring-x.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "ring-x.mix3", "config": "ring-x", "traffic": "mix3", "chips": 1, "why": "t"})
    bench["per_layer"].append({"name": "rounds_seen", "unit": "rounds", "better": "higher", "source": "host_clock",
                               "layer": "test", "moves": "edges_per_s", "workloads": ["ring-x.mix3"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    line = run(root, "ring-x.mix3", trace=True)
    assert line["correct"], line["checks"]
    assert line["attempted"] % 3 == 0
    assert line["metrics"]["rounds_seen"]["value"] == line["attempted"] / 3
    assert {"pagerank_max_rel_err", "bfs_level_mismatches"} <= set(line["checks"])
    plain = run(root, "ring-x.mix3")
    assert "rounds_seen" not in plain["metrics"] and "edges_per_s" in plain["metrics"]


def test_module_check_compares_whole_names(monkeypatch):
    assert "repro" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro_torch_extra", object())
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "repro.graph", object())
    assert harness.forbidden_modules() == ["repro"]
    monkeypatch.setitem(sys.modules, "jaxlib.xla", object())
    assert harness.forbidden_modules() == ["jaxlib", "repro"]


def test_every_rounds_answers_are_compared(checkout, monkeypatch):
    """One PageRank answer altered, the 40th query to finish (the window's
    second round, after the warm-up's 16 and the first round's 16): the
    per-round comparison sees it."""
    import repro_torch.algorithms as alg

    end, finished = alg.PageRankExecutor._end_iteration, []

    def alter_one(self):
        end(self)
        if self.finished() and id(self) not in finished:
            finished.append(id(self))
            if len(finished) == 40:
                self._rank[0] *= 1.001

    monkeypatch.setattr(alg.PageRankExecutor, "_end_iteration", alter_one)
    line = run(checkout, "tiny-grid.pr16", seconds=0.5)
    assert line["attempted"] >= 48
    assert not line["correct"]
    assert line["checks"]["pagerank_max_rel_err"]["value"] > 5e-4


def test_run_refuses_without_card(tmp_path):
    """Here there is no card: the command exits non-zero with no result."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "graphbench/run.py", "--workload", "grid-pr16", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["tiny-rmat.pr16", "tiny-rmat.bfs16", "tiny-rmat.dc16"])
def test_traced_cell_on_card(checkout, card, workload):
    """The kernels, the profile's check against the launch counters and the
    device metrics, on the card at the tiny size."""
    line = run(checkout, workload, trace=True, device=card)
    assert line["correct"], line["checks"]
    m = line["metrics"]
    assert 0 < m["device_idle_pct"]["value"] < 100
    assert 0 < m["device_roofline"]["value"] <= 100
    assert m["launches_per_step"]["value"] > 0
    assert line["device"]["busy_s"] > 0 and line["device"]["platform"] == "gpu"
    assert line["breakdown"]["device_ops"] and line["breakdown"]["idle_gaps"]


def test_benchmark_file_names_what_exists():
    """Every configuration, traffic mix, query kind, generator and metric
    that BENCHMARK.json names is a file of its own, and each name and unit
    keeps to the characters allowed."""
    import re

    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    gb = REPO / "graphbench"
    for c in bench["configs"]:
        conf = json.loads((REPO / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["reduced"] == c["reduced"] and len(c["source"]) <= 200
        assert (gb / "generators" / f"{conf['generator']}.py").is_file()
    cells = {w["name"] for w in bench["workloads"]}
    for w in bench["workloads"]:
        assert name.match(w["name"]) and len(w["why"]) <= 200 and w["chips"] == 1
        traffic = json.loads((gb / "traffic" / f"{w['traffic']}.json").read_text())
        for group in traffic["sessions"]:
            assert (gb / "queries" / f"{group['query']['kind']}.py").is_file()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert name.match(m["name"]) and unit.match(m["unit"]) and (gb / "metrics" / f"{m['name']}.py").is_file()
        assert set(m.get("workloads", cells)) <= cells
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
    for cell in cells:
        layer = [m for m in bench["per_layer"] if cell in m.get("workloads", [cell])]
        assert layer and "setup_s" in e2e and len(e2e) >= 2
    assert all(0.01 <= m["bound"] <= 0.25 for m in bench["end_to_end"])
