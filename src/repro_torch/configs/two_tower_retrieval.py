"""two-tower-retrieval [RecSys'19 (YouTube)]: embed_dim=256,
tower MLPs 1024-512-256, dot interaction.

Vocab sizes are powers of two (the paper gives none), the reference's
numbers. ``make_cell`` waits with the cell programs of ``launch.steps``."""
from ..launch.steps import RECSYS_SHAPES
from ..models.recsys import FieldSpec, TwoTowerConfig

ARCH_ID = "two-tower-retrieval"
FAMILY = "recsys"
SHAPES = list(RECSYS_SHAPES)


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
