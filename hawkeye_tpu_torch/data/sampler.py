"""Batch samplers (index-level, host side).

- ``RandomBatchSampler`` / ``SequentialBatchSampler``: standard epoch
  iteration with drop_last (train batches keep one static shape).
- ``BalancedBatchSampler``: P×K sampling — every batch holds ``n_classes``
  random classes × ``n_samples`` each, with a per-class cursor that
  reshuffles when exhausted. Needed by methods that mine pairs inside the
  batch (APINet/OSME+MAMC/CIN). Reference: ``dataset/sampler.py:5-38``.
"""

from __future__ import annotations

import numpy as np


class SequentialBatchSampler:
    def __init__(self, n, batch_size, drop_last=False):
        self.n = n
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __iter__(self):
        idx = np.arange(self.n)
        stop = (self.n // self.batch_size) * self.batch_size
        for i in range(0, stop, self.batch_size):
            yield idx[i:i + self.batch_size]
        if not self.drop_last and stop < self.n:
            yield idx[stop:]

    def __len__(self):
        q, r = divmod(self.n, self.batch_size)
        return q + (0 if self.drop_last or r == 0 else 1)


class RandomBatchSampler:
    def __init__(self, n, batch_size, drop_last=True, seed=0):
        self.n = n
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        rng = np.random.RandomState((self.seed * 1_000_003 + self.epoch) % 2**31)
        idx = rng.permutation(self.n)
        stop = (self.n // self.batch_size) * self.batch_size
        for i in range(0, stop, self.batch_size):
            yield idx[i:i + self.batch_size]
        if not self.drop_last and stop < self.n:
            yield idx[stop:]

    def __len__(self):
        q, r = divmod(self.n, self.batch_size)
        return q + (0 if self.drop_last or r == 0 else 1)


class WeightedRandomBatchSampler:
    """Class-frequency-weighted sampling with replacement (reference
    ``dataset/dataset_DCL.py:96-99`` get_weighted_sampler)."""

    def __init__(self, labels, batch_size, num_samples=None, seed=0):
        labels = np.asarray(labels)
        counts = np.bincount(labels)
        weights = 1.0 / np.maximum(counts[labels], 1)
        self.p = weights / weights.sum()
        self.n = len(labels)
        self.batch_size = batch_size
        self.num_samples = num_samples or self.n
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        rng = np.random.RandomState((self.seed * 1_000_003 + self.epoch) % 2**31)
        idx = rng.choice(self.n, size=self.num_samples, replace=True, p=self.p)
        stop = (self.num_samples // self.batch_size) * self.batch_size
        for i in range(0, stop, self.batch_size):
            yield idx[i:i + self.batch_size]

    def __len__(self):
        return self.num_samples // self.batch_size


class BalancedBatchSampler:
    """P×K batches: ``n_classes`` classes × ``n_samples`` items per batch.

    Matches the reference's behavior (``dataset/sampler.py:5-38``): the number
    of batches per epoch is ``len(dataset) // (n_classes * n_samples)``; each
    class keeps a shuffled index list and a cursor that wraps with reshuffle.
    """

    def __init__(self, labels, n_classes, n_samples, seed=0):
        self.labels = np.asarray(labels)
        self.classes = np.unique(self.labels)
        self.n_classes = int(n_classes)
        self.n_samples = int(n_samples)
        self.batch_size = self.n_classes * self.n_samples
        self.seed = seed
        self.epoch = 0
        self._per_class = {
            c: np.flatnonzero(self.labels == c) for c in self.classes
        }

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __iter__(self):
        rng = np.random.RandomState((self.seed * 1_000_003 + self.epoch) % 2**31)
        order = {c: rng.permutation(v) for c, v in self._per_class.items()}
        cursor = {c: 0 for c in self.classes}
        for _ in range(len(self)):
            chosen = rng.choice(self.classes, self.n_classes, replace=False)
            batch = []
            for c in chosen:
                idxs = order[c]
                start = cursor[c]
                if start + self.n_samples > len(idxs):
                    order[c] = rng.permutation(self._per_class[c])
                    idxs = order[c]
                    start = cursor[c] = 0
                batch.extend(idxs[start:start + self.n_samples])
                cursor[c] = start + self.n_samples
            yield np.asarray(batch)

    def __len__(self):
        return len(self.labels) // self.batch_size
