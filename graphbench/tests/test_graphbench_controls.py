"""The comparison that decides ``correct`` can fail: each query kind's
control (the reference in the precision below the program's, or with one
guarantee broken) falls outside its limit, and a run whose timed path is
broken underneath comes out not correct, for each fault a cell can have.
One card holds every cell, so no exchange between chips can be left out."""
from __future__ import annotations

import pytest
import torch

from graphbench import harness
from graphbench.control import control_readings
from graphbench.reference import GraphRef
from graphbench_tiny import REPO, run, tiny_checkout


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return tiny_checkout(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("workload", ["tiny-rmat.pr16", "tiny-grid.pr16", "tiny-rmat.bfs16", "tiny-grid.bfs16"])
def test_control_fails(checkout, workload):
    got = control_readings(checkout, workload, seed=11, rounds=4, device=torch.device("cpu"))
    assert any(c["value"] > c["limit"] for c in got.values()), got


def test_degree_count_control_fails_on_a_hub():
    """int16 counters wrap past 32,767 endpoints; the tiny graphs have no
    such hub, so the control is read on a star of 40,000 edges."""
    dc = harness.load_module(REPO, "queries", "degree_count")
    n = 40_000
    ref = GraphRef(torch.zeros(n, dtype=torch.int64), torch.arange(1, n + 1), n + 1)
    inst = ("degree_count", None)
    got = dc.compare(dc.control(ref, inst), dc.expected(ref, inst))
    assert got["degree_count_mismatches"] > dc.CHECKS["degree_count_mismatches"]["limit"]
    assert dc.compare(dc.expected(ref, inst).to(torch.int32), dc.expected(ref, inst))["degree_count_mismatches"] == 0


# ----------------------------------------------------------------- faults
def _state_unchanged(mp, alg):
    """A step whose result never reaches the query's state (its
    bookkeeping still runs, so the query ends)."""
    for cls, hook in ((alg.PageRankExecutor, "apply_pull_aggregate"), (alg.BFSExecutor, "apply_expansion"),
                      (alg.DegreeCountExecutor, "apply_counts")):
        orig = getattr(cls, hook)
        mp.setattr(cls, hook, lambda self, x, *a, _o=orig: _o(self, torch.zeros_like(x), *a))


def _half_the_batch(mp, alg):
    """Half of each step's work left out: PageRank's partial for the upper
    half of its targets, BFS's upper half of the frontier slots, the degree
    count's second half of each edge range (the first half counted twice,
    standing in for the whole)."""
    import repro_torch.kernels.degree_count.ops as dc_ops

    pr = alg.PageRankExecutor.apply_pull_aggregate

    def pr_half(self, agg, lo, hi, edges):
        agg = agg.clone()
        agg[(lo + hi) // 2 : hi] = 0
        return pr(self, agg, lo, hi, edges)

    bfs = alg.BFSExecutor.frontier_slot_vertices
    count = dc_ops.count_into

    def dc_half(ids, counts):
        part = ids[..., : ids.shape[-1] // 2]
        count(part, counts)
        return count(part, counts)

    mp.setattr(alg.PageRankExecutor, "apply_pull_aggregate", pr_half)
    mp.setattr(alg.BFSExecutor, "frontier_slot_vertices",
               lambda self, lo, hi: bfs(self, lo, hi)[: max((min(hi, self._n_frontier) - lo) // 2, 0)])
    mp.setattr(dc_ops, "count_into", dc_half)


def _answer_altered(mp, alg):
    """One value of the answer changed where the query produces it."""
    pr_end = alg.PageRankExecutor._end_iteration

    def pr_alter(self):
        pr_end(self)
        if self.finished():
            self._rank[0] *= 1.001

    bfs_end = alg.BFSExecutor.end_iteration

    def bfs_alter(self):
        bfs_end(self)
        if self._done:
            self._level[self.source] = 1

    dc_apply = alg.DegreeCountExecutor.apply_counts

    def dc_alter(self, counts, lo, hi):
        dc_apply(self, counts, lo, hi)
        if self._done:
            self._counters[0] += 1

    mp.setattr(alg.PageRankExecutor, "_end_iteration", pr_alter)
    mp.setattr(alg.BFSExecutor, "end_iteration", bfs_alter)
    mp.setattr(alg.DegreeCountExecutor, "apply_counts", dc_alter)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_the_batch, _answer_altered])
@pytest.mark.parametrize("workload", ["tiny-rmat.pr16", "tiny-grid.bfs16", "tiny-rmat.dc16"])
def test_broken_path_is_not_correct(checkout, workload, fault, monkeypatch):
    assert run(checkout, workload)["correct"]
    import repro_torch.algorithms as alg

    fault(monkeypatch, alg)
    line = run(checkout, workload)
    assert not line["correct"], line["checks"]
    assert line["attempted"] >= 16
