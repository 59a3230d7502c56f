"""Distribution layer (port of ``repro/dist``): the logical-axis sharding
rules and the int8 compressed gradient all-reduce.

One logical-axis table (``sharding.py``) maps every parameter, input,
cache and packed-delta leaf to a placement over a mesh;
``launch/mesh.py`` assembles these into the serving and training layouts
and pairs them with a live ``torch.distributed`` mesh.
``grad_compress.py`` is the training mesh's int8 data-parallel reduce.
"""
from repro_torch.dist.grad_compress import (
    ErrorFeedback,
    compressed_all_reduce,
    make_compressed_allreduce,
)
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
    "ErrorFeedback",
    "compressed_all_reduce",
    "make_compressed_allreduce",
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
