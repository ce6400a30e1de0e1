"""granite-34b [arXiv:2405.04324; hf]: dense llama-arch code model.
88L d_model=6144 48H (GQA kv=1) d_ff=24576 vocab=49152. ``make_cell`` waits
for the dry-run slice."""
from ..models.transformer import LMConfig
from .lm_common import SHAPES as SHAPES, smoke_lm

ARCH_ID = "granite-34b"
FAMILY = "lm"
OPTIMIZER = "adafactor"


def make_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID, n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1,
        d_ff=24576, vocab=49152, microbatches=16,
    )


def make_smoke_config() -> LMConfig:
    return smoke_lm(make_config())
