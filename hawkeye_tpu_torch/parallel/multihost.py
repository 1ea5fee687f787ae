"""Per-process data sharding for multi-process data parallelism.

Counterpart of ``hawkeye_tpu/parallel/multihost.py``: every process loads
only its slice of each global batch. ``ProcessShardedBatchSampler`` and
``PaddingAwareDataset`` are the JAX package's (plain numpy); the process
index and count default to this process's ``torch.distributed`` rank and
world size (0 and 1 without a process group) where the JAX package reads
``jax.process_index()``/``jax.process_count()``. The JAX package's
``global_batch_from_local`` has no counterpart: each process keeps its
slice on its own device, and the collectives of ``parallel/mesh.py`` join
what the JAX program's sharded arrays join.
"""

from __future__ import annotations

import numpy as np

from .mesh import world


class ProcessShardedBatchSampler:
    """Wrap a batch sampler so each process yields only its slice.

    The inner sampler must be deterministic given ``set_epoch`` (the
    RandomBatchSampler/BalancedBatchSampler are) so all processes agree on
    the global order.
    """

    def __init__(self, inner, process_index=None, process_count=None):
        rank, size = world()
        self.inner = inner
        self.process_index = rank if process_index is None else process_index
        self.process_count = size if process_count is None else process_count

    def set_epoch(self, epoch):
        if hasattr(self.inner, "set_epoch"):
            self.inner.set_epoch(epoch)

    def __iter__(self):
        n = self.process_count
        i = self.process_index
        for batch in self.inner:
            batch = np.asarray(batch, dtype=np.int64)
            rem = (-len(batch)) % n
            if rem:
                # Pad the GLOBAL batch to a process multiple instead of
                # truncating (a drop_last=False val tail must still be
                # evaluated exactly once on some process). Padding indices
                # are encoded as -1 - idx; PaddingAwareDataset decodes them
                # and marks the row weight 0 so it never counts.
                pad = np.full((rem,), -1 - int(batch[-1]), dtype=np.int64)
                batch = np.concatenate([batch, pad])
            per = len(batch) // n
            yield batch[i * per:(i + 1) * per]

    def __len__(self):
        return len(self.inner)


class PaddingAwareDataset:
    """Decodes ProcessShardedBatchSampler's encoded padding indices.

    Real index i -> item + weight 1; encoded pad (-1 - i) -> a copy of item
    i with weight 0, so the padded row flows through the collate and the
    batch prep and is masked out of every loss and metric."""

    def __init__(self, dataset):
        self.dataset = dataset

    def __len__(self):
        return len(self.dataset)

    def __getitem__(self, idx):
        idx = int(idx)
        pad = idx < 0
        if pad:
            idx = -1 - idx
        item = dict(self.dataset[idx])
        item["weight"] = np.float32(0.0 if pad else 1.0)
        return item
