"""API-Net: attentive pairwise interaction.

Counterpart of ``hawkeye_tpu/models/methods/apinet.py`` (reference
``model/methods/APINet.py``). In train mode with labels, each sample is
paired with its nearest same-class and nearest different-class neighbour in
the batch (``mine_pairs``, on the device); a mutual vector from ``map1`` ->
dropout -> ``map2`` gives sigmoid gates, and the gated features of both
members of each pair go through dropout and ``fc``: ``self_logits``,
``other_logits`` [4B, C], ``pair_labels`` [4B] and, with a per-sample
``weight``, ``pair_weight`` [4B] (every pair row takes its anchor's
weight). Eval mode, or no labels, returns ``logits`` only.

The heads read the trunk's spatial mean in their parameters' dtype
(float32, as the JAX package's ``pool``; float64 in a model cast to
float64). Dropout (rate 0.5) draws each of its five masks from the
``torch.Generator`` that the caller passes (``generator``), one mask per
site and call, as flax draws one per call; it never reads the global RNG.
Submodules carry the flax names (``backbone``, ``map1``, ``map2``, ``fc``).
"""

from __future__ import annotations

import torch
from torch import nn

from ...registry import BACKBONE, MODEL


def mine_pairs(embeddings, labels, valid=None):
    """Nearest same-class and different-class indices per sample, by
    squared L2 distance: the diagonal is out of the intra search, a row with
    no candidate falls back to index 0 (the first of an all-inf row, as
    ``argmin`` gives), and ``valid`` ([B] bool) takes padded rows out of the
    candidates."""
    sq = (embeddings ** 2).sum(dim=1)
    dist = sq[:, None] + sq[None, :] - 2.0 * (embeddings @ embeddings.T)
    n = embeddings.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=embeddings.device)
    same = labels[:, None] == labels[None, :]
    ok = (torch.ones((n,), dtype=torch.bool, device=embeddings.device)
          if valid is None else valid)
    inf = float("inf")
    intra = torch.where(same & ~eye & ok[None, :], dist, inf).argmin(dim=1)
    inter = torch.where(~same & ok[None, :], dist, inf).argmin(dim=1)
    return intra, inter


def dropout(x, rate, generator):
    """flax's ``nn.Dropout`` in train mode: keep with probability
    ``1 - rate`` (a uniform draw below it) and scale by ``1 / (1 - rate)``;
    the mask comes from ``generator``."""
    if rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


class APINet(nn.Module):
    def __init__(self, num_classes, backbone_name="resnet101", dropout_rate=0.5,
                 dtype=torch.bfloat16):
        super().__init__()
        self.dropout_rate = float(dropout_rate)
        self.backbone = BACKBONE.get(backbone_name)(num_classes=0, dtype=dtype)
        dim = self.backbone.out_channels
        self.map1 = nn.Linear(2 * dim, 512)
        self.map2 = nn.Linear(512, dim)
        self.fc = nn.Linear(dim, num_classes)

    def forward(self, x, labels=None, weight=None, generator=None):
        # the trunk's spatial mean (its "pool") in the head's dtype: float32
        # unless the model is cast
        pool = self.backbone(x)["c5"].mean(dim=(1, 2)).to(self.fc.weight.dtype)
        out = {"logits": self.fc(pool)}
        if not self.training or labels is None:
            return out
        if generator is None and self.dropout_rate > 0.0:
            raise ValueError("API-Net's train forward draws its dropout masks "
                             "from a generator: pass generator=")

        def drop(t):
            return dropout(t, self.dropout_rate, generator)

        valid = None if weight is None else weight > 0
        intra, inter = mine_pairs(pool.detach(), labels, valid=valid)
        f1 = torch.cat([pool, pool])
        f2 = torch.cat([pool[intra], pool[inter]])
        l1 = torch.cat([labels, labels])
        l2 = torch.cat([labels[intra], labels[inter]])

        mutual = self.map2(drop(self.map1(torch.cat([f1, f2], dim=1))))
        gate1 = torch.sigmoid(mutual * f1)
        gate2 = torch.sigmoid(mutual * f2)
        f1_self = gate1 * f1 + f1
        f1_other = gate2 * f1 + f1
        f2_self = gate2 * f2 + f2
        f2_other = gate1 * f2 + f2

        def head(f):
            return self.fc(drop(f))

        out["self_logits"] = torch.cat([head(f1_self), head(f2_self)])
        out["other_logits"] = torch.cat([head(f1_other), head(f2_other)])
        out["pair_labels"] = torch.cat([l1, l2])
        if weight is not None:
            w1 = torch.cat([weight, weight])  # the anchors' weights, [2B]
            out["pair_weight"] = torch.cat([w1, w1])
        return out


@MODEL.register(name="APINet")
def build_apinet(config):
    return APINet(num_classes=int(config.num_classes),
                  backbone_name=config.get("backbone", "resnet101"))
