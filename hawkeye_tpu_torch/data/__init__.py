from .dataset import FGDataset, SyntheticDataset, parse_metadata
from .loader import DataLoader, default_collate
from .sampler import (
    BalancedBatchSampler,
    RandomBatchSampler,
    SequentialBatchSampler,
    WeightedRandomBatchSampler,
)
from .transforms_host import EvalPreset, TrainPreset, build_transforms

__all__ = [
    "FGDataset",
    "SyntheticDataset",
    "parse_metadata",
    "DataLoader",
    "default_collate",
    "BalancedBatchSampler",
    "RandomBatchSampler",
    "SequentialBatchSampler",
    "WeightedRandomBatchSampler",
    "EvalPreset",
    "TrainPreset",
    "build_transforms",
]
