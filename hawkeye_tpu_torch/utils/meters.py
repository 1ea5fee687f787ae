"""Meters, accuracy, and timing utilities.

Reference: ``utils/utils.py:10-92`` (PerformanceMeter, AverageMeter, accuracy,
Timer). Accuracy here accepts numpy arrays (or anything ``np.asarray``
takes, such as CPU tensors); everything is host-side
bookkeeping so plain Python is the right tool.
"""

from __future__ import annotations

import time

import numpy as np


class PerformanceMeter:
    """Track per-epoch history plus best value / best epoch.

    Reference: ``utils/utils.py:10-29``.
    """

    def __init__(self, higher_is_better=True):
        self.higher_is_better = higher_is_better
        self.best_function = max if higher_is_better else min
        self.current_value = None
        self.best_value = None
        self.best_epoch = None
        self.values = []

    def update(self, new_value):
        self.values.append(float(new_value))
        self.current_value = float(new_value)
        self.best_value = self.best_function(self.values)
        self.best_epoch = self.values.index(self.best_value)

    @property
    def value(self):
        return self.current_value


class AverageMeter:
    """Running average over a stream of (value, count) updates.

    Reference: ``utils/utils.py:32-49``.
    """

    def __init__(self, name="meter"):
        self.name = name
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


def accuracy(logits, targets, topk=1):
    """Top-k accuracy in percent.

    Reference: ``utils/utils.py:52-66``. Accepts jnp/np arrays of shape
    [B, C] logits and [B] integer targets (or [B, C] one-hot / soft targets,
    in which case the argmax is used).
    """
    logits = np.asarray(logits)
    targets = np.asarray(targets)
    if targets.ndim == 2:
        targets = targets.argmax(axis=-1)
    k = min(topk, logits.shape[-1])
    topk_idx = np.argsort(-logits, axis=-1)[:, :k]
    correct = (topk_idx == targets[:, None]).any(axis=-1)
    return float(correct.mean() * 100.0)


class Timer:
    """Wall-clock stage timer. Reference: ``utils/utils.py:79-92``."""

    def __init__(self):
        self.start_time = time.time()
        self.last_time = self.start_time

    def tick(self):
        now = time.time()
        delta = now - self.last_time
        self.last_time = now
        return delta

    def total(self):
        return time.time() - self.start_time

    @staticmethod
    def format(seconds):
        m, s = divmod(int(seconds), 60)
        h, m = divmod(m, 60)
        return f"{h:d}:{m:02d}:{s:02d}"
