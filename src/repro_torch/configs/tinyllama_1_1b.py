"""tinyllama-1.1b [arXiv:2401.02385; hf]: llama2-arch small.
22L d_model=2048 32H (GQA kv=4) d_ff=5632 vocab=32000. ``make_cell`` waits
for the dry-run slice."""
from ..models.transformer import LMConfig
from .lm_common import SHAPES as SHAPES, smoke_lm

ARCH_ID = "tinyllama-1.1b"
FAMILY = "lm"
OPTIMIZER = "adamw"


def make_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID, n_layers=22, d_model=2048, n_heads=32, n_kv_heads=4,
        d_ff=5632, vocab=32000, microbatches=8,
    )


def make_smoke_config() -> LMConfig:
    return smoke_lm(make_config())
