"""Distribution layer: the logical-axis sharding rules (port of
``repro/dist``'s serving half).

One logical-axis table (``sharding.py``) maps every parameter, input,
cache and packed-delta leaf to a placement over a mesh;
``launch/mesh.py`` assembles these into the serving layouts and pairs
them with a live ``torch.distributed`` mesh. The compressed gradient
all-reduce (``repro/dist/grad_compress.py``) comes with the training
mesh.
"""
from repro_torch.dist.sharding import (
    DEFAULT_RULES,
    LONG_CONTEXT_OVERRIDES,
    SERVE_OVERRIDES,
    TRAIN_OVERRIDES,
    AbstractMesh,
    ShardingRules,
    batch_axes,
    cache_axes,
    tree_shardings,
    zero1_shardings,
)

__all__ = [
    "DEFAULT_RULES",
    "LONG_CONTEXT_OVERRIDES",
    "SERVE_OVERRIDES",
    "TRAIN_OVERRIDES",
    "AbstractMesh",
    "ShardingRules",
    "batch_axes",
    "cache_axes",
    "tree_shardings",
    "zero1_shardings",
]
