"""Prefetching host data loader.

Replaces the reference's ``torch.utils.data.DataLoader(num_workers=N)``
process pool (``train.py:200-209``) with a thread pool: PIL decode and
resize release the GIL in C, so threads give parallel decode without
pickling/fork overhead, and the loader double-buffers ``prefetch_batches``
batches ahead so the accelerator never waits on the host.
"""

from __future__ import annotations

import collections
from concurrent.futures import ThreadPoolExecutor

import numpy as np


def default_collate(items):
    """Stack a list of item dicts into a dict of batched numpy arrays."""
    out = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        if isinstance(vals[0], np.ndarray):
            out[key] = np.stack(vals)
        else:
            out[key] = np.asarray(vals)
    return out


class DataLoader:
    """Iterates batches of collated numpy arrays.

    Args:
      dataset: indexable with __len__.
      batch_sampler: iterable of index arrays (fresh each __iter__).
      num_workers: decode threads (0 = synchronous).
      collate_fn: list-of-items → batch dict.
      prefetch_batches: how many batches to keep in flight.
    """

    def __init__(self, dataset, batch_sampler, num_workers=4,
                 collate_fn=default_collate, prefetch_batches=2):
        self.dataset = dataset
        self.batch_sampler = batch_sampler
        self.num_workers = num_workers
        self.collate_fn = collate_fn
        self.prefetch_batches = max(1, prefetch_batches)
        self._pool = (
            ThreadPoolExecutor(max_workers=num_workers) if num_workers > 0 else None
        )

    def __iter__(self):
        if self._pool is None:
            for indices in self.batch_sampler:
                yield self.collate_fn([self.dataset[i] for i in indices])
            return
        # pipeline: keep `prefetch_batches` batches of per-item futures in
        # flight (per-item, not per-batch, so a batch can't occupy a worker
        # slot while waiting on its own items).
        pending = collections.deque()
        it = iter(self.batch_sampler)
        submit = lambda idx: [  # noqa: E731
            self._pool.submit(self.dataset.__getitem__, i) for i in idx
        ]
        try:
            for _ in range(self.prefetch_batches):
                pending.append(submit(next(it)))
        except StopIteration:
            pass
        while pending:
            futs = pending.popleft()
            try:
                pending.append(submit(next(it)))
            except StopIteration:
                pass
            yield self.collate_fn([f.result() for f in futs])

    def __len__(self):
        return len(self.batch_sampler)

    def set_epoch(self, epoch):
        if hasattr(self.batch_sampler, "set_epoch"):
            self.batch_sampler.set_epoch(epoch)
