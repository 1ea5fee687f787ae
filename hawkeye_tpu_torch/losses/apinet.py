"""API-Net loss: CE over the self and other logits + margin ranking.

Counterpart of ``hawkeye_tpu/losses/apinet.py`` (reference
``model/loss/APINet_loss.py:5-44``): CE with label smoothing 0.1 over the
stacked ``[self_logits; other_logits]`` and ``MarginRankingLoss(0.05)``
pushing each pair row's softmax score of its label under its own gate
above the score under its partner's; ``pair_weight`` weights both. In val
mode (no ``self_logits``) it is the plain CE.
"""

from __future__ import annotations

import torch

from ..registry import LOSS
from . import at_least_f32, cross_entropy


class APINetLoss:
    def __init__(self, config=None):
        cfg = config or {}
        get = cfg.get if hasattr(cfg, "get") else lambda k, d=None: d
        self.margin = float(get("margin", 0.05))

    def __call__(self, outputs, batch):
        if "self_logits" not in outputs:
            return cross_entropy(outputs["logits"], batch["label"], 0.1,
                                 weights=batch.get("weight"))
        self_logits = outputs["self_logits"]  # [4B, C]
        other_logits = outputs["other_logits"]
        labels = outputs["pair_labels"]
        pair_w = outputs.get("pair_weight")

        logits = torch.cat([self_logits, other_logits])
        ce_w = None if pair_w is None else torch.cat([pair_w, pair_w])
        softmax_loss = cross_entropy(logits, torch.cat([labels, labels]), 0.1,
                                     weights=ce_w)
        idx = labels[:, None].long()
        self_scores = torch.softmax(at_least_f32(self_logits), -1).gather(1, idx)[:, 0]
        other_scores = torch.softmax(at_least_f32(other_logits), -1).gather(1, idx)[:, 0]
        # MarginRankingLoss(margin)(x1, x2, y=1) = mean(max(0, -(x1 - x2) + m))
        hinge = torch.clamp_min(-(self_scores - other_scores) + self.margin, 0.0)
        if pair_w is None:
            rank_loss = hinge.mean()
        else:
            rank_loss = (hinge * pair_w).sum() / torch.clamp_min(pair_w.sum(), 1.0)
        return softmax_loss + rank_loss


LOSS.register(APINetLoss, name="APINetLoss")
