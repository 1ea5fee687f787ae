from .mesh import (
    all_reduce_sum,
    average_gradients,
    broadcast_module,
    init_from_env,
    local_rank,
    world,
)
from .multihost import PaddingAwareDataset, ProcessShardedBatchSampler

__all__ = [
    "all_reduce_sum",
    "average_gradients",
    "broadcast_module",
    "init_from_env",
    "local_rank",
    "world",
    "PaddingAwareDataset",
    "ProcessShardedBatchSampler",
]
