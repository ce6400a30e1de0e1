"""stablelm-1.6b [hf:stabilityai/stablelm-2-1_6b; unverified]: dense MHA
(kv=32 == heads). 24L d_model=2048 32H d_ff=5632 vocab=100352. ``make_cell``
waits for the dry-run slice."""
from ..models.transformer import LMConfig
from .lm_common import SHAPES as SHAPES, smoke_lm

ARCH_ID = "stablelm-1.6b"
FAMILY = "lm"
OPTIMIZER = "adamw"


def make_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID, n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
        d_ff=5632, vocab=100352, microbatches=8,
    )


def make_smoke_config() -> LMConfig:
    return smoke_lm(make_config())
