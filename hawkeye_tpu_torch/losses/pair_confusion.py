"""Pairwise Confusion loss: CE + lambda * euclidean confusion between the
two halves of the batch.

Counterpart of ``hawkeye_tpu/losses/pair_confusion.py`` (reference
``model/loss/pair_confusion.py:8-31``): the batch is split in two
(``b // 2`` rows each; an odd batch leaves its last row out of the pairs),
and for pairs with different labels the L2 distance between their logits is
added, summed and divided by the whole batch ``b``. CE has label smoothing
0.1 and the per-sample weights.

At a pair of equal rows the distance's gradient is 0 here
(``torch.linalg.vector_norm``); ``jnp.linalg.norm``'s is NaN on the JAX
side even where the pair is masked out.
"""

from __future__ import annotations

import torch

from ..registry import LOSS
from . import cross_entropy


class PairwiseConfusionLoss:
    def __init__(self, config=None):
        cfg = config or {}
        get = cfg.get if hasattr(cfg, "get") else lambda k, d=None: d
        self.lambda_a = float(get("lambda_a", 10.0))

    def __call__(self, outputs, batch):
        logits = outputs["logits"]
        labels = batch["label"]
        b = logits.shape[0]
        half = b // 2
        left, right = logits[:half], logits[half:2 * half]
        lab_l, lab_r = labels[:half], labels[half:2 * half]
        dist = torch.linalg.vector_norm(torch.abs(left - right), dim=1)
        diff = (lab_l != lab_r).float()
        w = batch.get("weight")
        if w is not None:  # rows of weight 0 are left out
            diff = diff * w[:half] * w[half:2 * half]
        conf = (dist * diff).sum() / b
        return cross_entropy(logits, labels, 0.1, weights=w) + self.lambda_a * conf


def entropic_confusion(probs):
    """sum p log p / B over softmax outputs (reference EntropicConfusion,
    ``model/loss/pair_confusion.py:34-36``)."""
    b = probs.shape[0]
    return (probs * torch.log(torch.clamp_min(probs, 1e-12))).sum() / b


LOSS.register(PairwiseConfusionLoss, name="PairwiseConfusionLoss")
