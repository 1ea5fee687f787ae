"""Criterion registry and the default cross-entropy.

Counterpart of ``hawkeye_tpu/losses/__init__.py``. Criterion contract:
``criterion(outputs: dict, batch: dict) -> scalar loss`` where ``outputs``
holds at least 'logits' and ``batch`` has 'label' (int [B]) or soft 'label'
[B, C], and optionally a per-sample 'weight' [B]. The reference's default is
``CrossEntropyLoss(label_smoothing=0.1)`` (``train.py:211-212``). Ported so
far: the cross-entropy, ``PairwiseConfusionLoss``, ``PeerLearningLoss``,
``MAMCLoss``, ``APINetLoss``, ``CINLoss``, ``CrossXLoss``,
``InterpPartsLoss``, ``ProtoTreeLoss`` and ``DCLLoss``; NTS-Net's, APCNN's,
S3N's and MGE-CNN's wait.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..registry import LOSS


def at_least_f32(t):
    """``t`` in float32, or in float64 where it is float64 (a model cast to
    float64 is its own reference)."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def cross_entropy(logits, labels, label_smoothing=0.0, weights=None):
    """CE over int or soft labels; ``weights`` [B] masks samples out."""
    logits = at_least_f32(logits)
    c = logits.shape[-1]
    if labels.dim() == logits.dim():  # soft labels (mixup/cutmix)
        target = labels.to(logits.dtype)
    else:
        target = F.one_hot(labels.long(), c).to(logits.dtype)
    if label_smoothing:
        target = target * (1.0 - label_smoothing) + label_smoothing / c
    losses = -(target * F.log_softmax(logits, dim=-1)).sum(dim=-1)
    if weights is None:
        return losses.mean()
    w = weights.to(logits.dtype)
    return (losses * w).sum() / torch.clamp_min(w.sum(), 1.0)


class CrossEntropyLoss:
    """Label-smoothed softmax cross entropy on ``outputs['logits']``."""

    def __init__(self, config=None):
        cfg = config or {}
        self.label_smoothing = float(
            cfg.get("label_smoothing", 0.1) if hasattr(cfg, "get") else 0.1)

    def __call__(self, outputs, batch):
        return cross_entropy(outputs["logits"], batch["label"],
                             self.label_smoothing, weights=batch.get("weight"))


LOSS.register(CrossEntropyLoss, name="CrossEntropyLoss")


def build_criterion(criterion_config):
    # late imports: loss modules register themselves on import
    from . import (  # noqa: F401
        apinet,
        cin,
        crossx,
        dcl,
        interp_parts,
        mamc,
        pair_confusion,
        peer_learning,
        prototree,
    )

    if criterion_config is None or "name" not in criterion_config:
        return CrossEntropyLoss()
    return LOSS.get(criterion_config.name)(criterion_config)
