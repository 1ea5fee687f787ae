"""DCL loss: alpha CE(class) + beta CE(swap) + gamma L1(mask, swap law).

Counterpart of ``hawkeye_tpu/losses/dcl.py`` (reference
``model/loss/DCL_loss.py:4-23``): both cross-entropies label-smoothed by
0.1, every term masked by the batch's ``weight``.
"""

from __future__ import annotations

import torch

from . import cross_entropy
from ..registry import LOSS


class DCLLoss:
    def __init__(self, config=None):
        cfg = config or {}
        get = cfg.get if hasattr(cfg, "get") else lambda k, d=None: d
        self.alpha = float(get("alpha", 1.0))
        self.beta = float(get("beta", 1.0))
        self.gamma = float(get("gamma", 1.0))

    def __call__(self, outputs, batch):
        w = batch.get("weight")
        loss_ce = cross_entropy(outputs["logits"], batch["label"], 0.1, weights=w)
        loss_swap = cross_entropy(outputs["swap_logits"], batch["label_swap"], 0.1,
                                  weights=w)
        l1 = (outputs["mask"] - batch["swap_law"]).abs().mean(dim=-1)
        if w is None:
            loss_law = l1.mean()
        else:
            w = w.to(l1.dtype)
            loss_law = (l1 * w).sum() / torch.clamp_min(w.sum(), 1.0)
        return self.alpha * loss_ce + self.beta * loss_swap + self.gamma * loss_law


LOSS.register(DCLLoss, name="DCLLoss")
