"""NTS loss: raw CE + concat CE + part CE + the proposal ranking hinge.

Counterpart of ``hawkeye_tpu/losses/nts.py`` (reference
``model/loss/NTS_loss.py:6-47``). The three CE terms are label-smoothed
(0.1); the parts' CE repeats each label and sample weight M times. The
ranking term reads the unsmoothed per-part NLL and asks every proposal
whose part loss is higher to score lower.
"""

from __future__ import annotations

import torch.nn.functional as F

from ..registry import LOSS
from . import at_least_f32, cross_entropy


def ranking_hinge(scores, part_losses):
    """sum_i sum_j max(0, 1 - s_i + s_j) * [l_j > l_i] / B: a strict
    ``>``, so tied part losses add nothing."""
    worse = part_losses[:, None, :] > part_losses[:, :, None]  # [B, i, j]
    margin = 1.0 - scores[:, :, None] + scores[:, None, :]
    return (margin.clamp_min(0.0) * worse.to(margin.dtype)).sum() / scores.shape[0]


class NTSLoss:
    def __init__(self, config=None):
        pass

    def __call__(self, outputs, batch):
        labels = batch["label"]
        w = batch.get("weight")
        raw_loss = cross_entropy(outputs["raw_logits"], labels, 0.1, weights=w)
        concat_loss = cross_entropy(outputs["logits"], labels, 0.1, weights=w)

        part_logits = outputs["part_logits"]  # [B, M, C]
        b, m, c = part_logits.shape

        def per_part(t):  # each sample's value M times, as jnp.repeat
            return t[:, None].expand(b, m).reshape(b * m)

        partcls_loss = cross_entropy(
            part_logits.reshape(b * m, c), per_part(labels), 0.1,
            weights=None if w is None else per_part(w))

        # the unsmoothed per-part NLL drives the ranking (reference list_loss)
        logp = F.log_softmax(at_least_f32(part_logits), dim=-1)
        part_nll = -logp.gather(-1, labels.long()[:, None, None].expand(b, m, 1))[..., 0]
        rank_loss = ranking_hinge(outputs["top_prob"], part_nll)
        return raw_loss + rank_loss + concat_loss + partcls_loss


LOSS.register(NTSLoss, name="NTSLoss")
