"""Shared plumbing for the LM arch configs. The reference's ``lm_cell``
(the training and dry-run cell programs) waits for the training slice."""
from __future__ import annotations

import dataclasses

import torch

from ..launch.steps import LM_SHAPES
from ..models.transformer import LMConfig

SHAPES = list(LM_SHAPES)


def smoke_lm(base_cfg: LMConfig) -> LMConfig:
    """Reduced same-family config: 2 layers, narrow dims, small vocab."""
    kv = min(base_cfg.n_kv_heads, 2)
    heads = max(4, kv * 2)
    moe = base_cfg.moe
    if moe is not None:
        moe = dataclasses.replace(moe, num_experts=min(moe.num_experts, 4))
    return dataclasses.replace(
        base_cfg,
        n_layers=2,
        d_model=64,
        n_heads=heads,
        n_kv_heads=kv,
        head_dim=16,
        d_ff=128,
        vocab=512,
        moe=moe,
        dtype=torch.float32,
        remat=False,
        microbatches=1,
        block_kv=16,
    )
