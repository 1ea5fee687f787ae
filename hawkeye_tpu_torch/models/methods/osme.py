"""OSME: one-squeeze multi-excitation attention (trained with the MAMC loss).

Counterpart of ``hawkeye_tpu/models/methods/osme.py`` (reference
``model/methods/OSME.py``): P parallel squeeze-and-excitation blocks over the
trunk's ``c5`` map (ResNet-101 by default). Each block's squeeze (the
spatial mean), ``fc1``/``fc2`` and sigmoid run in the trunk's dtype
(bfloat16 by default); its excited map, flattened in NHWC order and cast to
float32, feeds its own float32 ``part_fc_{p}`` to a 1024-d part feature.
The float32 classifier ``fc`` reads the sum of the part features. The
output is ``{"logits", "parts" [B, P, 1024]}``. The heads compute in their
parameters' dtype, so the model cast to float64 is its own reference.

``part_fc_{p}``'s input width is the flattened map, ``H*W*C`` of ``c5``
(7*7*2048 = 100352 at 224x224, so 102.8 M parameters a part), which flax
infers at init; here it comes from ``image_size``, the recipe's
``dataset.transformer.image_size`` (``models.build_model``). Submodules
carry the flax names (``backbone``, ``osme_{p}``, ``part_fc_{p}``, ``fc``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...registry import BACKBONE, MODEL


def dense(linear, x, dtype):
    """``linear`` with input, weight and bias in ``dtype``, as a flax Dense
    with ``dtype``."""
    bias = None if linear.bias is None else linear.bias.to(dtype)
    return F.linear(x.to(dtype), linear.weight.to(dtype), bias)


class OSMEBlock(nn.Module):
    """Squeeze (spatial mean), ``fc1`` -> ReLU -> ``fc2`` -> sigmoid, and the
    excitation of the NHWC map by the channel weights."""

    def __init__(self, channels, ratio=16, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Linear(channels, channels // ratio)
        self.fc2 = nn.Linear(channels // ratio, channels)

    def forward(self, x):
        z = x.mean(dim=(1, 2))
        m = torch.sigmoid(dense(self.fc2, F.relu(dense(self.fc1, z, self.dtype)),
                                self.dtype))
        return x * m[:, None, None, :]


class OSMENet(nn.Module):
    def __init__(self, num_classes, num_attention=2, part_dim=1024,
                 backbone_name="resnet101", image_size=224, dtype=torch.bfloat16):
        super().__init__()
        self.num_attention = int(num_attention)
        self.backbone = BACKBONE.get(backbone_name)(num_classes=0, dtype=dtype)
        c = self.backbone.out_channels
        flat = self.backbone.feature_size(image_size) ** 2 * c
        for p in range(self.num_attention):
            self.add_module(f"osme_{p}", OSMEBlock(c, dtype=dtype))
            self.add_module(f"part_fc_{p}", nn.Linear(flat, part_dim))
        self.fc = nn.Linear(part_dim, num_classes)

    def forward(self, x):
        feats = self.backbone(x)["c5"]  # NHWC view of channels-last memory
        b = feats.shape[0]
        parts = []
        for p in range(self.num_attention):
            s = getattr(self, f"osme_{p}")(feats)
            # the NHWC flatten of the excited map, as the JAX reshape; the
            # head's dtype (float32 unless the model is cast)
            fc = getattr(self, f"part_fc_{p}")
            parts.append(fc(s.reshape(b, -1).to(fc.weight.dtype)))
        logits = self.fc(sum(parts))
        return {"logits": logits, "parts": torch.stack(parts, dim=1)}


@MODEL.register(name="OSMENet")
def build_osme(config):
    return OSMENet(
        num_classes=int(config.num_classes),
        num_attention=int(config.get("num_attention", 2)),
        backbone_name=config.get("backbone", "resnet101"),
        image_size=int(config.get("image_size", 224)),
    )
