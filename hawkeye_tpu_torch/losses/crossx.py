"""CrossX loss: CE on the summed heads + part decorrelation + KL agreement.

Counterpart of ``hawkeye_tpu/losses/crossx.py`` (reference
``model/loss/CrossX_loss.py:6-64``): CE (label smoothing 0.1) on the sum of
the three heads' logits; ``regular_loss`` on each stage's pooled parts
(``ulti``, ``plty``, ``cmbn``, weighted by ``gamma``): the upper triangle
of the P x P mean correlation of the L2-normalised parts, ``1 - corr`` on
the diagonal, in its factorised form (the mean over (B, B) pairs of dot
products is the dot of the per-part mean vectors); and
``KL(log_softmax(plty) || softmax(ulti)) + KL(log_softmax(cmbn) ||
softmax(ulti))``, each a sum, divided by B. With one part, or outputs
without parts, it is the CE.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..registry import LOSS
from . import at_least_f32, cross_entropy


def regular_loss(parts, gamma):
    """parts: [B, P, D]."""
    p = parts.shape[1]
    x = F.normalize(at_least_f32(parts), dim=-1, eps=1e-12)
    m = x.mean(dim=0)  # [P, D]
    corr = m @ m.T
    eye = torch.eye(p, dtype=torch.bool, device=parts.device)
    corr = torch.where(eye, 1.0 - corr, corr)
    return gamma * torch.triu(corr).sum()


def _kl_sum(log_q, p):
    """``KLDivLoss(reduction='sum')(log_q, p)`` = sum p (log p - log_q), with
    0 where p is 0."""
    safe_log_p = torch.where(p > 0, torch.log(torch.clamp_min(p, 1e-30)), 0.0)
    return (p * (safe_log_p - log_q)).sum()


class CrossXLoss:
    def __init__(self, config=None):
        cfg = config or {}
        get = cfg.get if hasattr(cfg, "get") else lambda k, d=None: d
        self.num_parts = int(get("num_parts", 2))
        self.gamma = [float(g) for g in get("gamma", [1.0, 1.0, 1.0])]

    def __call__(self, outputs, batch):
        w = batch.get("weight")
        if self.num_parts == 1 or "ulti_parts" not in outputs:
            return cross_entropy(outputs["logits"], batch["label"], 0.1, weights=w)
        xf, xp, xc = (outputs[k] for k in ("logits_ulti", "logits_plty",
                                           "logits_cmbn"))
        cls_loss = cross_entropy(xf + xp + xc, batch["label"], 0.1, weights=w)
        reg = (regular_loss(outputs["ulti_parts"], self.gamma[0])
               + regular_loss(outputs["plty_parts"], self.gamma[1])
               + regular_loss(outputs["cmbn_parts"], self.gamma[2]))
        p_ulti = torch.softmax(xf, dim=-1)
        kl = (_kl_sum(F.log_softmax(xp, dim=-1), p_ulti)
              + _kl_sum(F.log_softmax(xc, dim=-1), p_ulti)) / xf.shape[0]
        return cls_loss + reg + kl


LOSS.register(CrossXLoss, name="CrossXLoss")
