"""grok-1-314b [hf:xai-org/grok-1; unverified]: MoE 8 experts top-2.
64L d_model=6144 48H (GQA kv=8) d_ff=32768 vocab=131072. ``make_cell``
waits for the dry-run slice."""
from ..layers.moe import MoEConfig
from ..models.transformer import LMConfig
from .lm_common import SHAPES as SHAPES, smoke_lm

ARCH_ID = "grok-1-314b"
FAMILY = "lm"
OPTIMIZER = "adafactor"


def make_config(dispatch: str = "dense", dispatch_groups: int = 16) -> LMConfig:
    return LMConfig(
        name=ARCH_ID, n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=32768, vocab=131072, microbatches=16,
        moe=MoEConfig(num_experts=8, top_k=2, dispatch=dispatch,
                      dispatch_groups=dispatch_groups if dispatch == "gather" else 1),
    )


def make_smoke_config() -> LMConfig:
    return smoke_lm(make_config())
