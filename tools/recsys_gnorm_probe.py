#!/usr/bin/env python3
"""Run-to-run spread of two-tower training's step-0 loss and gradient norm
at ``make_config()``'s full width, through the EmbeddingBag kernel and
through its plain version (``chip_smoke.py`` phase 14's control), with the
backward's table gradient scattered by ``index_add_`` (atomics, the port's)
and by ``index_put_(accumulate=True)`` (PyTorch's sort-based scatter-add).

    python3 tools/recsys_gnorm_probe.py

Needs one CUDA device. On the batch of phase 14 (``recsys_features``,
16,384 examples, seed 3) and ``TwoTower(seed=3)``, for each scatter: the
loss and gradient norm of 3 value-and-grad passes through the kernel and
2 through the plain version, their spread, each table's squared gradient
norm, the history table's hot row's gradient norm, and the wall ms of a
pass. The card's name and power limit come first.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels.embedding_bag import ops  # noqa: E402
from repro_torch.kernels.embedding_bag.embedding_bag import bag_index, take_rows, wrap_ids  # noqa: E402
from repro_torch.models import recsys as tt  # noqa: E402
from repro_torch.optim import clip_by_global_norm_  # noqa: E402


def put_backward(ctx, grad_out):
    """``EmbeddingBagFunction.backward`` with ``index_put_(accumulate=True)``
    in place of ``index_add_``."""
    table, ids, segments, weights = ctx.saved_tensors
    num_bags = ctx.num_bags
    bag = bag_index(segments, num_bags)
    g = torch.cat([grad_out, grad_out.new_zeros(1, grad_out.shape[1])])[bag]
    grad_table = grad_weights = None
    if ctx.needs_input_grad[0]:
        row, inside = wrap_ids(ids, table.shape[0])
        keep = inside & (bag < num_bags)
        contrib = torch.where(keep[:, None], g if weights is None else weights[:, None] * g, 0.0)
        grad_table = torch.zeros_like(table).index_put_((torch.where(keep, row, 0),), contrib, accumulate=True)
    if weights is not None and ctx.needs_input_grad[3]:
        grad_weights = (g * take_rows(table, ids)).sum(-1)
    return grad_table, None, None, grad_weights, None


def main() -> int:
    if not torch.cuda.is_available():
        print("recsys_gnorm_probe: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.nvidia_smi(), flush=True)
    dev = torch.device("cuda")
    cfg = get_arch("two-tower-retrieval").make_config()
    model = tt.TwoTower(cfg, seed=cs.SEED, device=dev)
    batch = cs.recsys_features(cfg, cs.RECSYS_BATCH, np.random.default_rng(cs.SEED), dev, step=0)
    hot = int(torch.bincount(batch["user"]["user_history"].reshape(-1).long()).argmax())

    def value_and_norm():
        model.zero_grad(set_to_none=True)
        loss = tt.loss_fn(cfg, model, batch)
        loss.backward()
        grads = tt.params_tree(model, grads=True)
        sq = {k: float((g.double() ** 2).sum()) for side in ("user_tables", "item_tables")
              for k, g in grads[side].items()}
        hot_norm = float(grads["user_tables"]["user_history"][hot].double().norm())
        gnorm = float(clip_by_global_norm_(grads, 1.0))
        del grads
        model.zero_grad(set_to_none=True)
        return float(loss.detach()), gnorm, hot_norm, sq

    kept = ops.EmbeddingBagFunction.backward
    for name, backward in (("index_add", kept), ("index_put_accumulate", staticmethod(put_backward))):
        ops.EmbeddingBagFunction.backward = backward
        runs = [value_and_norm() for _ in range(3)]
        with cs.plain_embedding_bag():
            control = [value_and_norm() for _ in range(2)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            value_and_norm()
        torch.cuda.synchronize()
        g, c = [r[1] for r in runs], [r[1] for r in control]
        print(json.dumps({name: {
            "loss": [r[0] for r in runs], "control_loss": [r[0] for r in control],
            "gnorm": g, "control_gnorm": c, "gnorm_spread_rel": (max(g) - min(g)) / g[0],
            "vs_control_rel": [abs(x - y) / y for x in g for y in c],
            "hot_row": hot, "hot_row_grad_norm": [r[2] for r in runs], "table_grad_sq": runs[0][3],
            "value_grad_ms": (time.perf_counter() - t0) / 3 * 1e3}}), flush=True)
    ops.EmbeddingBagFunction.backward = kept
    return 0


if __name__ == "__main__":
    sys.exit(main())
