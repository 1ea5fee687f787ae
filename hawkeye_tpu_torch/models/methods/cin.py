"""CIN: channel interaction network.

Counterpart of ``hawkeye_tpu/models/methods/cin.py`` (reference
``model/methods/CIN.py:10-60``). SCI: the float32 channel bilinear
``X^T X / HW`` [B, C, C] of the trunk's ``c5`` map (ResNet-50 by default),
a softmax of its negative over the last axis, ``Y = W X`` (the einsum
``bcd,bpd->bpc``), one 3x3 ``conv`` in the trunk's dtype and the residual;
the float32 ``classifier`` reads the spatial mean. In train mode, CCI pairs
sample i with its batch-half partner (``roll(arange(B), -(B//2))``): a
scalar gate from ``gate_fc`` over the NHWC-flattened ``[Y_i, Y_partner]``
[B, 2*HW*C], ``|W_i - gate * W_partner|`` applied as in SCI, through the
SAME ``conv`` module (its gradient sums both uses), and ``pair_head``
[B, HW*C] -> ``r_channel`` gives ``pair_embed``. Eval mode has no
``pair_embed``. The float32 parts compute in the classifier's dtype, so
the model cast to float64 is its own reference.

``gate_fc`` and ``pair_head`` read the flattened map, whose width flax
infers at init; here it comes from ``image_size``, the recipe's
``dataset.transformer.image_size`` (``models.build_model``). Submodules
carry the flax names (``backbone``, ``conv``, ``gate_fc``, ``classifier``,
``pair_head``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...registry import BACKBONE, MODEL


class CIN(nn.Module):
    def __init__(self, num_classes, backbone_name="resnet50", r_channel=512,
                 image_size=224, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.backbone = BACKBONE.get(backbone_name)(num_classes=0, dtype=dtype)
        c = self.backbone.out_channels
        flat = self.backbone.feature_size(image_size) ** 2 * c
        self.conv = nn.Conv2d(c, c, 3, 1, 1)
        self.gate_fc = nn.Linear(2 * flat, 1)
        self.classifier = nn.Linear(c, num_classes)
        self.pair_head = nn.Linear(flat, int(r_channel))

    def _conv(self, y):
        """``conv`` on NHWC ``y``, in the trunk's dtype, back to ``y``'s."""
        x = y.to(self.dtype).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        w = self.conv.weight.to(self.dtype, memory_format=torch.channels_last)
        out = F.conv2d(x, w, self.conv.bias.to(self.dtype), 1, 1)
        return out.permute(0, 2, 3, 1).to(y.dtype)

    def forward(self, x):
        feats = self.backbone(x)["c5"]  # NHWC view of channels-last memory
        b, h, w, c = feats.shape
        # positions x C in NHWC order, in the head's dtype (float32 unless
        # the model is cast)
        xf = feats.reshape(b, h * w, c).to(self.classifier.weight.dtype)
        bilinear = torch.bmm(xf.transpose(1, 2), xf) / float(h * w)  # [B, C, C]
        w_sci = torch.softmax(-bilinear, dim=2)
        y = self._conv(torch.bmm(xf, w_sci.transpose(1, 2)).reshape(b, h, w, c))
        z = y.reshape(b, h * w, c) + xf
        out = {"logits": self.classifier(z.mean(dim=1))}
        if not self.training:
            return out

        # CCI: sample i with its partner (i + B//2) mod B
        shift = -(b // 2)
        yb = y.reshape(b, -1)
        gate = self.gate_fc(torch.cat([yb, torch.roll(yb, shift, 0)], dim=1))
        w_cci = torch.abs(w_sci - gate[:, :, None] * torch.roll(w_sci, shift, 0))
        y_cci = self._conv(torch.bmm(xf, w_cci.transpose(1, 2)).reshape(b, h, w, c))
        z_cci = y_cci.reshape(b, h * w, c) + xf
        out["pair_embed"] = self.pair_head(z_cci.reshape(b, -1))
        return out


@MODEL.register(name="CIN")
def build_cin(config):
    return CIN(num_classes=int(config.num_classes),
               backbone_name=config.get("backbone", "resnet50"),
               r_channel=int(config.get("r_channel", 512)),
               image_size=int(config.get("image_size", 224)))
