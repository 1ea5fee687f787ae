"""MAMC loss: CE + the n-pairs multi-attention multi-class constraint.

Counterpart of ``hawkeye_tpu/losses/mamc.py`` (reference
``model/loss/MAMC_loss.py:6,24``): the B x P part features, L2-normalised,
form an n = B*P similarity matrix; each anchor adds
``log(1 + sum_neg exp(sim_neg - sim_pos))`` over three partitions of its
positives and negatives by same/different class and same/different
attention part. Vectorised as the JAX package does it: with
``S_i = sum_k neg[i, k] * exp(sim[i, k])`` every term is
``log1p(exp(-sim[i, j]) * S_i)`` over the [n, n] grid. A per-sample
``weight`` of 0 takes a row out as anchor, positive and negative alike. CE
has label smoothing 0.1.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..registry import LOSS
from . import at_least_f32, cross_entropy


def npairs_mamc(parts, labels, weights=None):
    """parts: [B, P, D]; labels: [B] int; weights: [B] 0/1. Scalar loss."""
    b, p, d = parts.shape
    n = b * p
    x = F.normalize(at_least_f32(parts.reshape(n, d)), dim=-1, eps=1e-12)
    sim = x @ x.T  # [n, n], in [-1, 1]

    lab = labels.repeat_interleave(p)  # [n]
    part = torch.arange(p, device=parts.device).repeat(b)  # [n]
    same_class = lab[:, None] == lab[None, :]
    same_part = part[:, None] == part[None, :]
    if weights is None:
        valid = torch.ones((n,), dtype=torch.bool, device=parts.device)
        n_anchor = float(n)
    else:
        valid = (weights > 0).repeat_interleave(p)
        n_anchor = valid.sum().to(x.dtype).clamp_min(1.0)
    vpair = valid[:, None] & valid[None, :]

    s_sasc = same_class & same_part & vpair
    s_sadc = ~same_class & same_part & vpair
    s_dasc = same_class & ~same_part & vpair
    s_dadc = ~same_class & ~same_part & vpair
    exp_sim, exp_neg_sim = torch.exp(sim), torch.exp(-sim)

    def quadrant_loss(pos_mask, neg_mask):
        neg_exp = torch.where(neg_mask, exp_sim, 0.0).sum(dim=1)  # S_i, [n]
        terms = torch.log1p(exp_neg_sim * neg_exp[:, None])  # [n, n]
        return torch.where(pos_mask, terms, 0.0).sum()

    loss = (quadrant_loss(s_sasc, s_sadc | s_dasc | s_dadc)
            + quadrant_loss(s_sadc, s_dadc)
            + quadrant_loss(s_dasc, s_dadc))
    return loss / n_anchor


class MAMCLoss:
    """CE (label smoothing 0.1) + lambda_a * n-pairs over the parts."""

    def __init__(self, config=None):
        cfg = config or {}
        get = cfg.get if hasattr(cfg, "get") else lambda k, d=None: d
        self.lambda_a = float(get("lambda_a", 0.5))
        self.use_mamc = bool(get("use_mamc", True))

    def __call__(self, outputs, batch):
        w = batch.get("weight")
        loss_ce = cross_entropy(outputs["logits"], batch["label"], 0.1, weights=w)
        if not self.use_mamc or "parts" not in outputs:
            return loss_ce
        return loss_ce + self.lambda_a * npairs_mamc(
            outputs["parts"], batch["label"], weights=w)


LOSS.register(MAMCLoss, name="MAMCLoss")
