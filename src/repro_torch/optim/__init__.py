"""Optimizers and gradient compression (the reference's ``repro.optim``)."""
from .optimizers import (
    CHUNK_ROWS, OptimizerConfig, make_optimizer, adamw_init, adamw_update, adamw_update_,
    adafactor_init, adafactor_update, clip_by_global_norm, clip_by_global_norm_, lr_schedule,
    opt_state_from_jax, opt_state_logical_axes,
)
from .compression import ef_init, ef_compress, ef_decompress, compressed_bytes
