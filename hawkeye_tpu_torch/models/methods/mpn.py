"""Fast MPN-COV: covariance pooling with an iterative matrix square root.

Counterpart of ``hawkeye_tpu/models/methods/mpn.py`` (reference
``model/methods/MPNCOV.py:41-102``): the trunk's ``c5`` map, a 1x1 conv
2048 -> ``dimension_reduction`` (no bias, in the trunk's dtype) with the
flax-semantics BatchNorm and a ReLU, then covariance pooling, ``iter_num``
Newton-Schulz steps and the upper triangle (``ops/isqrt.py``, float32),
then a float32 linear classifier. ``dimension_reduction`` None or 0 skips
the reduction; ``is_sqrt``/``is_vec`` False skip the square root and use
the whole matrix. ``input_dim`` is read by the recipes and ignored, as in
the JAX package. The submodules carry the flax names (``backbone``,
``dr_conv``, ``dr_bn``, ``fc``), so the weight bridge and the parameter
groups of ``examples/MPN.py`` find them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.isqrt import covariance_pool, newton_schulz_sqrt, triu_vec
from ...registry import BACKBONE, MODEL
from ..backbones.norm import BatchNorm


class MPN(nn.Module):
    def __init__(self, num_classes, iter_num=5, is_sqrt=True, is_vec=True,
                 dimension_reduction=256, backbone_name="resnet50",
                 coupled_newton_schulz=True, dtype=torch.bfloat16):
        super().__init__()
        self.iter_num = int(iter_num)
        self.is_sqrt = bool(is_sqrt)
        self.is_vec = bool(is_vec)
        self.dimension_reduction = dimension_reduction or None
        self.coupled_newton_schulz = bool(coupled_newton_schulz)
        self.dtype = dtype
        self.backbone = BACKBONE.get(backbone_name)(num_classes=0, dtype=dtype)
        dim = self.backbone.out_channels
        if self.dimension_reduction:
            self.dr_conv = nn.Conv2d(dim, self.dimension_reduction, 1, bias=False)
            self.dr_bn = BatchNorm(self.dimension_reduction, momentum=0.9, eps=1e-5)
            dim = self.dimension_reduction
        feat = dim * (dim + 1) // 2 if self.is_vec else dim * dim
        self.fc = nn.Linear(feat, num_classes, dtype=torch.float32)

    def forward(self, x):
        feats = self.backbone(x)["c5"]  # NHWC view of channels-last memory
        if self.dimension_reduction:
            y = feats.permute(0, 3, 1, 2)
            w = self.dr_conv.weight.to(self.dtype, memory_format=torch.channels_last)
            y = F.relu(self.dr_bn(F.conv2d(y, w)))
            feats = y.permute(0, 2, 3, 1)
        cov = covariance_pool(feats)  # [B, C, C] float32
        if self.is_sqrt:
            cov = newton_schulz_sqrt(cov, self.iter_num,
                                     coupled_batched=self.coupled_newton_schulz)
        v = triu_vec(cov) if self.is_vec else cov.reshape(cov.shape[0], -1)
        return {"logits": self.fc(v), "features": v}


@MODEL.register(name="MPN")
def build_mpn(config):
    return MPN(
        num_classes=int(config.num_classes),
        iter_num=int(config.get("iter_num", 5)),
        is_sqrt=bool(config.get("is_sqrt", True)),
        is_vec=bool(config.get("is_vec", True)),
        dimension_reduction=config.get("dimension_reduction", 256),
        backbone_name=config.get("backbone", "resnet50"),
        coupled_newton_schulz=bool(config.get("coupled_newton_schulz", True)),
    )
