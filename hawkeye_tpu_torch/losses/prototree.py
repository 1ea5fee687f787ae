"""ProtoTree loss and leaf update.

Counterpart of ``hawkeye_tpu/losses/prototree.py``. ``ProtoTreeLoss`` is
the negative log-likelihood of the tree's mixture prediction (the model's
``logits`` are its log-probabilities), masked by the batch's ``weight``.
``leaf_update`` is the reference's derivative-free leaf step
(``Examples/ProtoTreeNet.py:115-131``), a running-average replacement of
the previous epoch's contribution.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..registry import LOSS


class ProtoTreeLoss:
    def __init__(self, config=None):
        pass

    def __call__(self, outputs, batch):
        logp = outputs["logits"]
        nll = -logp.gather(1, batch["label"].long()[:, None])[:, 0]
        w = batch.get("weight")
        if w is None:
            return nll.mean()
        w = w.to(nll.dtype)
        return (nll * w).sum() / torch.clamp_min(w.sum(), 1.0)


LOSS.register(ProtoTreeLoss, name="ProtoTreeLoss")


def leaf_update(leaf_params, old_params_over_batches, pa_leaf, leaf_dist, pred,
                labels, num_classes):
    """``relu(params - old / num_batches) + update`` with
    ``update[l, c] = sum_b pa[b, l] dist[l, c] 1[y_b = c] / pred[b, c]``."""
    onehot = F.one_hot(labels.long(), num_classes).to(pred.dtype)
    ratio = onehot / torch.clamp_min(pred, 1e-12)  # [B, C]
    update = (pa_leaf.T @ ratio) * leaf_dist
    return torch.clamp_min(leaf_params - old_params_over_batches, 0.0) + update
