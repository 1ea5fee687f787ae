"""MultiSmoothLoss for S3N's four heads.

Counterpart of ``hawkeye_tpu/losses/s3n.py`` (reference
``model/loss/S3N_loss.py:6-35``). Heads, in order: ``logits`` (the
aggregation), ``agg_origin``, ``agg_sampler``, ``agg_sampler1``. The second
and the last take a smoothed target, ``smooth_ratio`` on the true class and
``(1 - r) / (C - 1)`` on every other; the other two plain CE. A per-sample
``weight`` masks samples out of every head.
"""

from __future__ import annotations

import torch.nn.functional as F

from ..registry import LOSS
from . import at_least_f32


def _masked_mean(losses, weights):
    if weights is None:
        return losses.mean()
    w = weights.to(losses.dtype)
    return (losses * w).sum() / w.sum().clamp_min(1.0)


class MultiSmoothLoss:
    def __init__(self, config=None):
        cfg = config or {}
        get = cfg.get if hasattr(cfg, "get") else lambda k, d=None: d
        self.smooth_ratio = float(get("smooth_ratio", 0.85))

    def _ce(self, logits, labels, weights, smooth):
        logits = at_least_f32(logits)
        c = logits.shape[-1]
        onehot = F.one_hot(labels.long(), c).to(logits.dtype)
        if smooth:
            r = self.smooth_ratio
            target = r * onehot + (1 - r) * (1 - onehot) / (c - 1)
        else:
            target = onehot
        return _masked_mean(-(F.log_softmax(logits, dim=-1) * target).sum(-1), weights)

    def __call__(self, outputs, batch):
        labels, w = batch["label"], batch.get("weight")
        heads = (outputs["logits"], outputs["agg_origin"], outputs["agg_sampler"],
                 outputs["agg_sampler1"])
        return sum(self._ce(h, labels, w, smooth=i in (1, len(heads) - 1))
                   for i, h in enumerate(heads))


LOSS.register(MultiSmoothLoss, name="MultiSmoothLoss")
