"""Peer-learning loss: agreement/disagreement split and small-loss exchange.

Counterpart of ``hawkeye_tpu/losses/peer_learning.py`` (reference
``model/loss/peer_learning_loss.py:5-67``): samples where the two peers
disagree always train both; where they agree, each peer keeps only the
``floor((1 - drop_rate) * n_agree)`` samples with the lowest loss as its
PEER ranks them. The selection is a static-shape mask (per-sample CE, ranks
by a double stable argsort, keep rank < num_remember), so a step is the same
program for every epoch's drop rate.

``num_remember`` is computed in float32, as the JAX step computes it with
the drop rate as a weak float32: in float64 a ramp value such as 0.027777778
can land on the other side of an integer. Both argsorts are stable, as
``jnp.argsort`` is, so tied losses keep the lower index first.
"""

from __future__ import annotations

import numpy as np
import torch

from ..registry import LOSS


def _per_sample_ce(logits, labels):
    """logsumexp(logits) - logits[label], per row, float32."""
    logits = logits.float()
    label_logits = logits.gather(-1, labels.long()[:, None])[:, 0]
    return torch.logsumexp(logits, dim=-1) - label_logits


def peer_keep_masks(logits1, logits2, labels, drop_rate, weight=None):
    """(keep_for_1, keep_for_2, ce1, ce2): the samples each peer trains on
    and the per-sample losses."""
    valid = torch.ones_like(labels, dtype=torch.float32) if weight is None else weight
    pred1 = logits1.argmax(-1)
    pred2 = logits2.argmax(-1)
    agree = (pred1 == pred2) & (valid > 0)
    disagree = (pred1 != pred2) & (valid > 0)

    ce1 = _per_sample_ce(logits1, labels)
    ce2 = _per_sample_ce(logits2, labels)

    # float32 throughout, as JAX's weak-float32 drop rate; a host scalar,
    # so no per-step copy to the device
    keep_rate = np.float32(1.0) - np.float32(drop_rate)
    num_remember = torch.floor(agree.sum().float() * float(keep_rate))

    def keep_mask(peer_ce):
        """Among agreement samples, keep the num_remember lowest peer losses."""
        masked = torch.where(agree, peer_ce, torch.full_like(peer_ce, float("inf")))
        order = torch.argsort(masked, stable=True)
        ranks = torch.argsort(order, stable=True)  # rank of each sample
        return agree & (ranks < num_remember)

    # peer 2 ranks what peer 1 keeps, and the other way round
    return disagree | keep_mask(ce2), disagree | keep_mask(ce1), ce1, ce2


def peer_learning_losses(logits1, logits2, labels, drop_rate, weight=None):
    """Returns (loss1, loss2) scalars with the masked small-loss exchange."""
    keep1, keep2, ce1, ce2 = peer_keep_masks(logits1, logits2, labels,
                                             drop_rate, weight)

    def masked_mean(ce, mask):
        m = mask.float()
        return (ce * m).sum() / torch.clamp_min(m.sum(), 1.0)

    return masked_mean(ce1, keep1), masked_mean(ce2, keep2)


class PeerLearningLoss:
    """Criterion: reads 'drop_rate' from the batch (set per epoch by the
    Peer-Learning trainer's rate schedule; 0 where it is absent)."""

    def __init__(self, config=None):
        pass

    def __call__(self, outputs, batch):
        loss1, loss2 = peer_learning_losses(
            outputs["logits1"], outputs["logits2"], batch["label"],
            batch.get("drop_rate", 0.0), weight=batch.get("weight"))
        return loss1 + loss2


LOSS.register(PeerLearningLoss, name="PeerLearningLoss")
