"""Baseline classifiers: a bare backbone + linear head.

Counterpart of ``hawkeye_tpu/models/methods/baseline.py`` (reference
``model/backbone/resnet.py:403-412``, used by ``Examples/Baseline.py`` with
``configs/Baseline.yaml``): the backbone's float32 ``pool`` feeds a float32
``fc``; the trunk computes in ``dtype`` (``config.dtype``, bfloat16 unless it
says float32). Registered as ResNet18/34/50/101/152 and VGG16.
"""

from __future__ import annotations

import torch
from torch import nn

from ...registry import BACKBONE, MODEL


class BaselineClassifier(nn.Module):
    def __init__(self, backbone_name, num_classes, dtype=torch.bfloat16,
                 stem_space_to_depth=False):
        super().__init__()
        kwargs = {}
        if stem_space_to_depth:
            kwargs["stem_space_to_depth"] = True  # resnets only
        self.backbone = BACKBONE.get(backbone_name)(num_classes=0, dtype=dtype,
                                                    **kwargs)
        self.fc = nn.Linear(self.backbone.out_channels, num_classes,
                            dtype=torch.float32)

    def forward(self, x):
        return {"logits": self.fc(self.backbone(x)["pool"])}


def _register_baseline(model_name, backbone_name):
    def factory(config):
        return BaselineClassifier(
            backbone_name=backbone_name,
            num_classes=int(config.num_classes),
            dtype=(torch.float32
                   if str(config.get("dtype", "bfloat16")) in ("float32", "f32")
                   else torch.bfloat16),
            stem_space_to_depth=bool(config.get("stem_space_to_depth", False)),
        )

    factory.__name__ = model_name
    MODEL.register(factory, name=model_name)


_register_baseline("ResNet50", "resnet50")
_register_baseline("ResNet101", "resnet101")
_register_baseline("ResNet18", "resnet18")
_register_baseline("ResNet34", "resnet34")
_register_baseline("ResNet152", "resnet152")
_register_baseline("VGG16", "vgg16")
