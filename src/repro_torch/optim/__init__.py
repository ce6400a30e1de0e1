"""Optimizers and gradient compression (the reference's ``repro.optim``)."""
from .optimizers import (
    OptimizerConfig, make_optimizer, adamw_init, adamw_update,
    adafactor_init, adafactor_update, clip_by_global_norm, lr_schedule,
    opt_state_from_jax,
)
from .compression import ef_init, ef_compress, ef_decompress, compressed_bytes
