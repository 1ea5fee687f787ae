"""Plain reference of ``baseline_resnet50_448``: ResNet-50 v1.5 (He et al.
2016, the stride on the bottleneck's 3x3) with a 200-way linear
classifier, float32, TF32 off.

Stem: 7x7/2 conv (padding 3, no bias), BatchNorm, ReLU, 3x3/2 max pool
(padding 1). Four stages of 3, 4, 6 and 3 bottlenecks (1x1 reduce, 3x3, 1x1
expand by 4; a 1x1 projection with BatchNorm on the first block of each
stage), then the spatial mean and the classifier. BatchNorm normalises with
the batch's mean and biased variance (eps 1e-5) over the whole global batch:
what the program's cross-replica statistics give across ranks. Parameter
names follow the program's (``backbone.conv1``, ``backbone.layer1_0.bn2``,
``fc``), so both draw the same init from the seed.

The step runs the whole batch at once, since its statistics span it; each
block runs under ``torch.utils.checkpoint`` so that the activations of the
timed batch fit on the card.

``train_flops_per_image``: convs and the classifier, forward x 3, less the
stem conv's input gradient.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .common import BatchNorm, conv, cross_entropy_sum, linear, lowp

STAGES = (3, 4, 6, 3)


class Bottleneck(nn.Module):
    def __init__(self, c_in, filters, stride, downsample):
        super().__init__()
        c_out = filters * 4
        self.conv1 = nn.Conv2d(c_in, filters, 1, bias=False)
        self.bn1 = BatchNorm(filters)
        self.conv2 = nn.Conv2d(filters, filters, 3, stride, 1, bias=False)
        self.bn2 = BatchNorm(filters)
        self.conv3 = nn.Conv2d(filters, c_out, 1, bias=False)
        self.bn3 = BatchNorm(c_out)
        self.downsample = downsample
        if downsample:
            self.downsample_conv = nn.Conv2d(c_in, c_out, 1, stride, bias=False)
            self.downsample_bn = BatchNorm(c_out)

    def forward(self, x, precision):
        bn = lambda m, t: lowp(m(t), precision)  # noqa: E731
        out = F.relu(bn(self.bn1, conv(x, self.conv1, precision)))
        out = F.relu(bn(self.bn2, conv(out, self.conv2, precision)))
        out = bn(self.bn3, conv(out, self.conv3, precision))
        identity = x
        if self.downsample:
            identity = bn(self.downsample_bn, conv(x, self.downsample_conv, precision))
        return F.relu(lowp(out + identity, precision))


class Backbone(nn.Module):
    def __init__(self, stages=STAGES):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm(64)
        self.blocks = []
        c_in, filters = 64, 64
        for i, n in enumerate(stages):
            for j in range(n):
                stride = (1 if i == 0 else 2) if j == 0 else 1
                name = f"layer{i + 1}_{j}"
                self.add_module(name, Bottleneck(
                    c_in, filters, stride, j == 0 and (stride != 1 or c_in != filters * 4)))
                self.blocks.append(name)
                c_in = filters * 4
            filters *= 2
        self.out_channels = c_in

    def forward(self, x, precision):
        x = F.relu(lowp(self.bn1(conv(x, self.conv1, precision)), precision))
        x = F.max_pool2d(x, 3, 2, 1)
        for name in self.blocks:
            block = getattr(self, name)
            if torch.is_grad_enabled():
                x = checkpoint(block, x, precision, use_reentrant=False)
            else:
                x = block(x, precision)
        return x.mean(dim=(2, 3))


class Baseline(nn.Module):
    def __init__(self, num_classes):
        super().__init__()
        self.backbone = Backbone()
        self.fc = nn.Linear(self.backbone.out_channels, num_classes)

    def forward(self, x_nhwc, precision="float32"):
        return linear(self.backbone(x_nhwc.permute(0, 3, 1, 2), precision),
                      self.fc, precision)


def build(run_cfg):
    return Baseline(int(run_cfg["model"]["num_classes"]))


def loss_and_backward(model, imgs, labels, precision, generator=None, per_rank=None):
    """Mean loss over the rows; the gradients accumulate in ``.grad``. The
    model draws nothing of its own, so ``generator`` and ``per_rank`` go
    unused."""
    loss = cross_entropy_sum(model(imgs, precision), labels) / imgs.shape[0]
    loss.backward()
    return float(loss.detach())


# ---------------------------------------------------------------------------
# operations, from shapes
# ---------------------------------------------------------------------------
def _convs(image_size=448):
    """(out h, out w, c_in, c_out, k) of every conv."""
    s = (image_size - 1) // 2 + 1
    convs = [(s, s, 3, 64, 7)]
    s = (s - 1) // 2 + 1  # the stem's max pool
    c_in, filters = 64, 64
    for i, n in enumerate(STAGES):
        for j in range(n):
            stride = (1 if i == 0 else 2) if j == 0 else 1
            s_out = (s - 1) // stride + 1
            convs += [(s, s, c_in, filters, 1), (s_out, s_out, filters, filters, 3),
                      (s_out, s_out, filters, filters * 4, 1)]
            if j == 0 and (stride != 1 or c_in != filters * 4):
                convs.append((s_out, s_out, c_in, filters * 4, 1))
            c_in, s = filters * 4, s_out
        filters *= 2
    return convs, c_in


def forward_flops_per_image(image_size=448, num_classes=200):
    convs, c = _convs(image_size)
    return sum(2 * h * w * ci * co * k * k for h, w, ci, co, k in convs) + 2 * c * num_classes


def train_flops_per_image(image_size=448, num_classes=200):
    """Forward x 3, less the stem conv's data gradient."""
    h, w, ci, co, k = _convs(image_size)[0][0]
    return 3 * forward_flops_per_image(image_size, num_classes) - 2 * h * w * ci * co * k * k


KERNEL_WORK = {}
