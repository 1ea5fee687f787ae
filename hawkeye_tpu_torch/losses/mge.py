"""MGE-CNN loss: the mean of the label-smoothed CE over the 10 heads.

Counterpart of ``hawkeye_tpu/losses/mge.py`` (reference
``Examples/MGE_CNN.py:37-56``); ``label_smoothing`` defaults to 0.1.
"""

from __future__ import annotations

from ..registry import LOSS
from . import cross_entropy


class MGELoss:
    def __init__(self, config=None):
        cfg = config or {}
        get = cfg.get if hasattr(cfg, "get") else lambda k, d=None: d
        self.label_smoothing = float(get("label_smoothing", 0.1))

    def __call__(self, outputs, batch):
        heads = outputs["all_logits"]  # [N, B, C]
        return sum(cross_entropy(heads[i], batch["label"], self.label_smoothing,
                                 weights=batch.get("weight"))
                   for i in range(heads.shape[0])) / heads.shape[0]


LOSS.register(MGELoss, name="MGELoss")
