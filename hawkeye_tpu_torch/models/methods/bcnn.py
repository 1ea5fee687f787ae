"""BCNN: bilinear CNN pooling over VGG conv5 features.

Counterpart of ``hawkeye_tpu/models/methods/bcnn.py`` (reference
``model/methods/BCNN.py``): the post-pool5 VGG map -> bilinear pooling
(C x C Gram / HW) -> signed sqrt + L2 normalisation -> linear classifier, in
float32 on top of a ``dtype`` trunk. Two-stage training: stage 1 stops
gradients at the features (the JAX model's ``stop_gradient``; here the
backbone runs with autograd off), stage 2 fine-tunes everything from the
stage-1 best model. ``fused_pooling`` selects the Gram kernel
(``ops/fused_bilinear.py``).
"""

from __future__ import annotations

import torch
from torch import nn

from ...ops.bilinear import bilinear_pool
from ...ops.fused_bilinear import bilinear_pool_fused
from ...registry import BACKBONE, MODEL


class BCNN(nn.Module):
    def __init__(self, num_classes, stage=2, backbone_name="vgg16",
                 fused_pooling=False, efficient_pool=True, remat_first=True,
                 fast_dgrad=False, dtype=torch.bfloat16):
        super().__init__()
        self.stage = int(stage)
        self.fused_pooling = bool(fused_pooling)
        kwargs = {}
        if backbone_name.startswith("vgg"):
            kwargs = dict(efficient_pool=efficient_pool,
                          remat_first=remat_first, fast_dgrad=fast_dgrad)
        self.backbone = BACKBONE.get(backbone_name)(num_classes=0, dtype=dtype,
                                                    **kwargs)
        c = self.backbone.out_channels
        self.fc = nn.Linear(c * c, num_classes, dtype=torch.float32)

    def forward(self, x):
        # the reference's backbone is the whole torchvision features stack,
        # final max pool included, so the head sees the post-pool5 map
        with torch.set_grad_enabled(torch.is_grad_enabled() and self.stage != 1):
            feats = self.backbone(x)["pooled_features"]
        if self.fused_pooling:
            v = bilinear_pool_fused(feats)
        else:
            v = bilinear_pool(feats)  # [B, C*C], f32, sqrt + L2 normalised
        return {"logits": self.fc(v), "features": v}


@MODEL.register(name="BCNN")
def build_bcnn(config):
    return BCNN(
        num_classes=int(config.num_classes),
        stage=int(config.get("stage", 2)),
        backbone_name=config.get("backbone", "vgg16"),
        fused_pooling=bool(config.get("fused_pooling", False)),
        efficient_pool=bool(config.get("efficient_pool", True)),
        remat_first=bool(config.get("remat_first", True)),
        fast_dgrad=bool(config.get("fast_dgrad", False)),
    )
