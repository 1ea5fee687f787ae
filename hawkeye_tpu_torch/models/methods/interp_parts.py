"""Interpretable Parts (IP-ResNet): region grouping with a part dictionary.

Counterpart of ``hawkeye_tpu/models/methods/interp_parts.py`` (reference
``model/methods/Interp_Parts.py``). A ResNet trunk cut after its third
stage (``strides (1, 2, 2)``, output ``c4``, 1024 channels) feeds a
``GroupingUnit``: the HW positions soft-assign to K part centres (the raw
parameter ``weight`` [K, C]) by ``clip(2 x.c - |x|^2 - |c|^2, max 0) /
sigmoid(smooth_factor)`` and a softmax over the parts; the assigned mean
of each part, less its centre, over ``sqrt(beta / 2)``, L2-normalised, is
its region feature [B, K, C]. The regions go as a [B, K, 1, C] map through
1x1-conv bottlenecks (``Bottleneck1x1``, float32, BatchNorm statistics over
B*K, ``bn3`` starting at scale 0): two ``attconv`` blocks, ``attconv_out``
and ``attconv_bn`` to one attention logit per part, a ReLU and a softmax
over the parts; four ``post`` blocks to 2048 channels. Their
attention-weighted sum over the parts, ``groupingbn`` (statistics over B)
and ``mylinear`` give ``logits``; ``att`` [B, K] and ``assign``
[B, H, W, K] go to the loss. Registered as ``IP_ResNet50`` and
``IP_ResNet101``.

The grouping unit computes in its centres' dtype (float32, as the JAX
package's; float64 in a model cast to float64). The region map is held NCHW
as [B, C, K, 1] (a 1x1 conv is the same
function in either layout); submodules and raw parameters carry the flax
names (``backbone``, ``grouping.weight``, ``grouping.smooth_factor``,
``attconv_{0,1}``, ``attconv_out``, ``attconv_bn``, ``post_{0..3}``,
``groupingbn``, ``mylinear``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ...registry import MODEL
from ..backbones.norm import BatchNorm
from ..backbones.resnet import Bottleneck, ResNet
from ..init import _TRUNC_STD

_BN = dict(momentum=0.9, eps=1e-5)


class GroupingUnit(nn.Module):
    def __init__(self, num_parts, channels):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_parts, channels))
        self.smooth_factor = nn.Parameter(torch.zeros(num_parts))

    @torch.no_grad()
    def init_own_parameters(self, generator):
        """The reference's MSRA init clamped at 1e-5, as flax's
        ``kaiming_normal`` draws it: a normal truncated at two standard
        deviations, variance 2 / fan_in with fan_in = K (the JAX package's
        ``[K, C]`` shape); ``smooth_factor`` 0."""
        std = math.sqrt(2.0 / self.weight.shape[0]) / _TRUNC_STD
        nn.init.trunc_normal_(self.weight, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)
        self.weight.clamp_(min=1e-5)
        self.smooth_factor.zero_()

    def forward(self, feats):
        """feats: NHWC [B, H, W, C] -> (region features [B, K, C], assign
        [B, H, W, K])."""
        b, h, w, c = feats.shape
        k = self.weight.shape[0]
        centers = self.weight  # float32 unless the model is cast
        x = feats.reshape(b, h * w, c).to(centers.dtype)  # NHWC order
        beta = torch.sigmoid(self.smooth_factor)  # [K]
        cx = x @ centers.T  # [B, HW, K]
        x_sq = (x ** 2).sum(-1, keepdim=True)
        c_sq = (centers ** 2).sum(-1)[None, None, :]
        logits = torch.clamp(2 * cx - x_sq - c_sq, max=0.0) / beta
        assign = torch.softmax(logits, dim=-1)  # over parts, [B, HW, K]
        qx = torch.bmm(assign.transpose(1, 2), x)  # [B, K, C]
        sum_ass = torch.clamp(assign.sum(dim=1), min=1e-5)[..., None]
        sigma = torch.sqrt(beta / 2.0)[None, :, None]
        out = F.normalize((qx / sum_ass - centers[None]) / sigma, dim=-1,
                          eps=1e-12)
        return out, assign.reshape(b, h, w, k)


def _for_norm(y, bn):
    """A 1x1 conv's output on the [B, C, K, 1] region map, in channels-last
    memory where ``bn`` takes the cross-replica path, whose kernels take that
    layout (the conv gives the NCHW one: with W = 1 its input's layout is
    ambiguous); as it is otherwise."""
    return y.contiguous(memory_format=torch.channels_last) if bn.cross_replica else y


class Bottleneck1x1(nn.Module):
    """A bottleneck whose spatial conv is 1x1, float32, on the [B, C, K, 1]
    region map; ``bn3`` starts at scale 0 (the reference zero-inits the
    last BN's gamma in residual blocks)."""

    def __init__(self, c_in, filters, downsample=False):
        super().__init__()
        self.conv1 = nn.Conv2d(c_in, filters, 1, bias=False)
        self.bn1 = BatchNorm(filters, **_BN)
        self.conv2 = nn.Conv2d(filters, filters, 1, bias=False)
        self.bn2 = BatchNorm(filters, **_BN)
        self.conv3 = nn.Conv2d(filters, filters * 4, 1, bias=False)
        self.bn3 = BatchNorm(filters * 4, **_BN)
        self.downsample = downsample
        if downsample:
            self.downsample_conv = nn.Conv2d(c_in, filters * 4, 1, bias=False)
            self.downsample_bn = BatchNorm(filters * 4, **_BN)

    @torch.no_grad()
    def init_own_parameters(self, generator):
        self.bn3.weight.zero_()

    def forward(self, x):
        out = F.relu(self.bn1(_for_norm(self.conv1(x), self.bn1)))
        out = F.relu(self.bn2(_for_norm(self.conv2(out), self.bn2)))
        out = self.bn3(_for_norm(self.conv3(out), self.bn3))
        identity = x
        if self.downsample:
            identity = self.downsample_bn(_for_norm(self.downsample_conv(x),
                                                    self.downsample_bn))
        return F.relu(out + identity)


class InterpParts(nn.Module):
    def __init__(self, num_classes, num_parts=5, stage_sizes=(3, 4, 6),
                 dtype=torch.bfloat16):
        super().__init__()
        self.backbone = ResNet(Bottleneck, stage_sizes, num_classes=0,
                               strides=(1, 2, 2), dtype=dtype)
        c = self.backbone.out_channels  # 1024
        self.grouping = GroupingUnit(num_parts, c)
        self.attconv_0 = Bottleneck1x1(c, 256)
        self.attconv_1 = Bottleneck1x1(1024, 256)
        self.attconv_out = nn.Conv2d(1024, 1, 1)
        self.attconv_bn = BatchNorm(1, **_BN)
        self.post_0 = Bottleneck1x1(c, 512, downsample=True)
        for i in range(1, 4):
            self.add_module(f"post_{i}", Bottleneck1x1(2048, 512))
        self.groupingbn = BatchNorm(2048, **_BN)
        self.mylinear = nn.Linear(2048, num_classes)

    def forward(self, x):
        feats = self.backbone(x)["c4"]  # NHWC [B, H, W, 1024]
        region, assign = self.grouping(feats)
        rf = region.transpose(1, 2)[..., None]  # [B, C, K, 1]

        att = self.attconv_1(self.attconv_0(rf))
        att = F.relu(self.attconv_bn(self.attconv_out(att)))
        att = torch.softmax(att, dim=2)  # over parts, [B, 1, K, 1]

        pf = rf
        for i in range(4):
            pf = getattr(self, f"post_{i}")(pf)
        # the attention-weighted SUM over the parts
        pooled = (pf * att).sum(dim=(2, 3))  # [B, 2048]
        pooled = self.groupingbn(pooled[:, :, None, None])[:, :, 0, 0]
        return {"logits": self.mylinear(pooled), "att": att[:, 0, :, 0],
                "assign": assign}


def _build_ip(stage_sizes):
    def factory(config):
        return InterpParts(num_classes=int(config.num_classes),
                           num_parts=int(config.get("num_parts", 5)),
                           stage_sizes=stage_sizes)

    return factory


MODEL.register(_build_ip((3, 4, 6)), name="IP_ResNet50")
MODEL.register(_build_ip((3, 4, 23)), name="IP_ResNet101")
