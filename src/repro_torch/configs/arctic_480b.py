"""arctic-480b [hf:Snowflake/snowflake-arctic-base; hf]: MoE 128 experts
top-2 + dense residual. 35L d_model=7168 56H (GQA kv=8) d_ff=4864
vocab=32000.

Note: 56 heads are not divisible by the 16-way 'model' axis — attention
weights replicate across 'model' in the sharding plan."""
from ..layers.moe import MoEConfig
from ..models.transformer import LMConfig
from .lm_common import SHAPES as SHAPES, lm_cell, smoke_lm

ARCH_ID = "arctic-480b"
FAMILY = "lm"
OPTIMIZER = "adafactor"


def make_config(dispatch: str = "dense", dispatch_groups: int = 16) -> LMConfig:
    return LMConfig(
        name=ARCH_ID, n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
        d_ff=4864, vocab=32000, microbatches=16,
        moe=MoEConfig(num_experts=128, top_k=2, dispatch=dispatch, dense_residual=True,
                      dispatch_groups=dispatch_groups if dispatch == "gather" else 1),
    )


def make_smoke_config() -> LMConfig:
    return smoke_lm(make_config())


def make_cell(shape: str, *, dispatch: str = "dense", **overrides):
    return lm_cell(make_config(dispatch), shape, OPTIMIZER, **overrides)
