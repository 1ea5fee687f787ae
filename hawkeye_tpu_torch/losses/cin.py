"""CIN loss: CE + alpha * a contrastive loss across the batch halves.

Counterpart of ``hawkeye_tpu/losses/cin.py`` (reference
``model/loss/CIN_loss.py:7-47``): CE (label smoothing 0.1) on the SCI
logits plus, on the projected CCI features ``pair_embed`` of rows i and
i + B/2, ``d^2`` for a same-class pair and ``max(beta - d, 0)^2`` for a
different-class one, summed. The JAX package's deltas from the reference
(``PARITY.md``), kept here: the pair labels compare elementwise, the hinge
is squared, ``d = sqrt(d^2 + 1e-12)`` so its gradient is finite at 0, and a
pair counts with the weight ``w[:h] * w[h:2h]``. The projection (the
reference criterion's ``h``) is the model's ``pair_head``; in eval mode
there is no ``pair_embed`` and the loss is the CE.
"""

from __future__ import annotations

import torch

from ..registry import LOSS
from . import cross_entropy


class CINLoss:
    def __init__(self, config=None):
        cfg = config or {}
        get = cfg.get if hasattr(cfg, "get") else lambda k, d=None: d
        self.alpha = float(get("alpha", 2.0))
        self.beta = float(get("beta", 0.5))

    def __call__(self, outputs, batch):
        w = batch.get("weight")
        loss_ce = cross_entropy(outputs["logits"], batch["label"], 0.1, weights=w)
        if "pair_embed" not in outputs:
            return loss_ce
        z = outputs["pair_embed"]  # [B, R]
        labels = batch["label"]
        half = z.shape[0] // 2
        za, zb = z[:half], z[half:2 * half]
        same = (labels[:half] == labels[half:2 * half]).to(z.dtype)
        d2 = ((za - zb) ** 2).sum(dim=1)
        d = torch.sqrt(d2 + 1e-12)
        pull = same * d2
        push = (1.0 - same) * torch.clamp_min(self.beta - d, 0.0) ** 2
        pair = pull + push
        if w is not None:
            pair = w[:half] * w[half:2 * half] * pair
        return loss_ce + self.alpha * pair.sum()


LOSS.register(CINLoss, name="CINLoss")
