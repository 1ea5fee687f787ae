"""DCL: destruction-construction learning.

Counterpart of ``hawkeye_tpu/models/methods/dcl.py`` (reference
``model/methods/DCL.py``): a ResNet trunk (``backbone`` is a registered
name here, not a dict) and three float32 heads. ``convmask`` (1x1 conv with
bias to one channel) on c5, a 2x2 mean by reshape (so c5's side must be
even), ``tanh`` and flatten give ``mask``, which regresses the jigsaw's
swap law; the bias-free ``classifier`` and ``classifier_swap`` (2 classes,
or 2C without ``cls_2``) take c5's spatial mean. The heads compute in their
parameters' dtype (float32; float64 in a model cast to float64). The data
side is ``data/dcl.py``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...registry import BACKBONE, MODEL


class DCL(nn.Module):
    def __init__(self, num_classes, cls_2=True, backbone_name="resnet50",
                 dtype=torch.bfloat16):
        super().__init__()
        self.backbone = BACKBONE.get(backbone_name)(num_classes=0, dtype=dtype)
        c = self.backbone.out_channels
        self.convmask = nn.Conv2d(c, 1, 1, bias=True)
        self.classifier = nn.Linear(c, num_classes, bias=False)
        self.classifier_swap = nn.Linear(c, 2 if cls_2 else 2 * num_classes,
                                         bias=False)

    def forward(self, x):
        feats = self.backbone(x)["c5"]  # NHWC
        w = self.convmask.weight
        mask = F.linear(feats.to(w.dtype), w.flatten(1), self.convmask.bias)
        b, h, w_, _ = mask.shape
        mask = mask.reshape(b, h // 2, 2, w_ // 2, 2).mean(dim=(2, 4))  # 2x2 mean
        # the spatial mean in the trunk's dtype, then the heads', as
        # jnp.mean(...).astype(float32)
        pooled = feats.mean(dim=(1, 2)).to(w.dtype)
        return {"logits": self.classifier(pooled),
                "swap_logits": self.classifier_swap(pooled),
                "mask": torch.tanh(mask).reshape(b, -1)}


@MODEL.register(name="DCL")
def build_dcl(config):
    return DCL(num_classes=int(config.num_classes),
               cls_2=bool(config.get("cls_2", True)),
               backbone_name=config.get("backbone", "resnet50"))
