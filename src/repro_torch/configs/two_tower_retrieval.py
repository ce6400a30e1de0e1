"""two-tower-retrieval [RecSys'19 (YouTube)]: embed_dim=256,
tower MLPs 1024-512-256, dot interaction, sampled softmax.

Vocab sizes are powers of two (the paper gives none), the reference's
numbers. The model trains with ``launch.steps.recsys_train_step`` under
:data:`OPTIMIZER` (the optimizer of the reference's ``make_cell``) and
serves with ``recsys_serve_step``, the steps of ``make_cell``'s programs."""
from ..launch.steps import RECSYS_SHAPES, make_recsys_cell
from ..models.recsys import FieldSpec, TwoTowerConfig
from ..optim import OptimizerConfig

ARCH_ID = "two-tower-retrieval"
FAMILY = "recsys"
SHAPES = list(RECSYS_SHAPES)
OPTIMIZER = OptimizerConfig(name="adamw", lr=1e-3)


def make_config() -> TwoTowerConfig:
    return TwoTowerConfig(
        embed_dim=256, tower_mlp=(1024, 512, 256),
        user_fields=(
            FieldSpec("user_id", 8_388_608),
            FieldSpec("user_history", 1_048_576, multi_hot=32),
            FieldSpec("user_geo", 131_072),
        ),
        item_fields=(
            FieldSpec("item_id", 8_388_608),
            FieldSpec("item_category", 16_384),
            FieldSpec("item_tags", 131_072, multi_hot=8),
        ),
    )


def make_smoke_config() -> TwoTowerConfig:
    return TwoTowerConfig(
        embed_dim=16, tower_mlp=(32, 16),
        user_fields=(FieldSpec("user_id", 1024), FieldSpec("user_history", 512, multi_hot=4)),
        item_fields=(FieldSpec("item_id", 1024), FieldSpec("item_category", 64)),
    )


def make_cell(shape: str, **_):
    return make_recsys_cell(make_config(), shape, OPTIMIZER)
