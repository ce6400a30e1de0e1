"""The PageRank-pull seam as it was before ranges were applied in place, for
the CPU tests and the card tests to hold the port against: each merged
range's tile sums masked to ``[lo, hi)`` in a new ``[V]`` vector (the
unpadding) and added to the whole accumulator. Imports no JAX (the machine
with the card has none)."""
from __future__ import annotations

import torch

from repro_torch import core
from repro_torch.kernels.spmv import spmv_tiles
from repro_torch.kernels.spmv.spmv import DST_TILE


class UnpaddingCudaBackend(core.CudaBackend):
    """``CudaBackend`` with the earlier PageRank-pull step: a fresh output a
    launch, the unpadding, and a full ``acc + agg`` with the executor's
    bookkeeping (edge count, coverage, the commit at full coverage)."""

    def _execute_pr_pull(self, plan, step) -> None:
        h, ex = plan.handle, plan.executor
        for lo, hi in self._ranges(plan, step):
            t0, t1 = lo // DST_TILE, -(-hi // DST_TILE)
            flat = spmv_tiles(h.tables, ex.contrib, t0, t1).reshape(-1)
            base = t0 * DST_TILE
            ids = base + torch.arange(flat.shape[0], device=flat.device)
            masked = torch.where((ids >= lo) & (ids < hi), flat, 0.0)
            agg = torch.zeros((h.num_vertices,), dtype=flat.dtype, device=flat.device)
            end = min(base + flat.shape[0], h.num_vertices)
            agg[base:end] = masked[: end - base]
            ex._acc = ex._acc + agg
            ex._edges += float(h.edge_prefix[hi] - h.edge_prefix[lo])
            ex._covered += hi - lo
            if ex._covered >= h.num_vertices:
                ex._end_iteration()
