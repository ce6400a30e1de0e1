"""Shared plumbing for the five LM arch configs."""
from __future__ import annotations

import dataclasses

import torch

from ..launch.steps import CellProgram, LM_SHAPES, make_lm_cell
from ..models.transformer import LMConfig
from ..optim import OptimizerConfig

SHAPES = list(LM_SHAPES)


def lm_cell(
    base_cfg: LMConfig,
    shape: str,
    optimizer: str,
    *,
    n_layers_override: int | None = None,
    microbatches_override: int | None = None,
    seq_parallel: bool = False,
) -> CellProgram:
    cfg = base_cfg
    if n_layers_override is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers_override)
    if microbatches_override is not None:
        cfg = dataclasses.replace(cfg, microbatches=microbatches_override)
    if seq_parallel:
        cfg = dataclasses.replace(cfg, seq_parallel=True)
    if shape != "train_4k":
        cfg = dataclasses.replace(cfg, microbatches=1)
    opt_cfg = OptimizerConfig(name=optimizer)
    return make_lm_cell(cfg, shape, opt_cfg)


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
