"""Plain reference of ``bcnn_vgg16_s2``: BCNN on VGG-16 (Lin et al., ICCV
2015), float32, TF32 off.

VGG-16 (configuration D) convs, each 3x3 with padding 1 and a bias, then
ReLU, with a 2x2 max pool after each of the five blocks; the post-pool5 map
X [B, HW, 512] gives the Gram ``X^T X / HW``, its signed square root
``sign(g) sqrt(|g| + 1e-5)``, flattened and L2-normalised, and a 512*512 ->
200 linear classifier. Parameter names follow the program's
(``backbone.features.<i>``, ``fc``), so both draw the same init from the
seed and the check can pair the leaves.

The step runs in blocks of rows (the model has no batch statistics, so the
summed gradients of the blocks are the batch's), which keeps the reference
inside the card's memory at the timed batch.

Operations and bytes of the step and of the ported kernels' launches,
counted from shapes, are here too: ``train_flops_per_image`` (convs, the
Gram and the classifier, forward x 3, less the first conv's input
gradient) and ``KERNEL_WORK``.
"""

from __future__ import annotations

import torch
from torch import nn

from .common import conv, cross_entropy_sum, head, linear

CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
       512, 512, 512, "M"]
ROW_BLOCK = 32


class Backbone(nn.Module):
    def __init__(self, cfg=CFG):
        super().__init__()
        self.cfg = list(cfg)
        self.features = nn.ModuleDict()
        idx, c_in = 0, 3
        for v in self.cfg:
            if v == "M":
                idx += 1
                continue
            self.features[str(idx)] = nn.Conv2d(c_in, v, 3, padding=1)
            c_in = v
            idx += 2  # conv, relu

    def forward(self, x, precision):
        idx = 0
        for v in self.cfg:
            if v == "M":
                x = torch.nn.functional.max_pool2d(x, 2, 2)
                idx += 1
            else:
                x = torch.relu(conv(x, self.features[str(idx)], precision))
                idx += 2
        return x


class BCNN(nn.Module):
    def __init__(self, num_classes, cfg=CFG):
        super().__init__()
        self.backbone = Backbone(cfg)
        c = [v for v in cfg if v != "M"][-1]
        self.fc = nn.Linear(c * c, num_classes)

    def forward(self, x_nhwc, precision="float32"):
        f = self.backbone(x_nhwc.permute(0, 3, 1, 2), precision)  # [B, C, h, w]
        b, c, h, w = f.shape
        x = f.reshape(b, c, h * w)
        g = head(torch.bmm(x, x.transpose(1, 2)) / float(h * w), precision)
        v = (torch.sign(g) * torch.sqrt(torch.abs(g) + 1e-5)).reshape(b, c * c)
        v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True).clamp_min(1e-12)
        return linear(v, self.fc, precision)


def build(run_cfg):
    return BCNN(int(run_cfg["model"]["num_classes"]))


def loss_and_backward(model, imgs, labels, precision, generator=None, per_rank=None):
    """Mean loss over the rows; the gradients accumulate in ``.grad``. The
    model draws nothing of its own, so ``generator`` and ``per_rank`` go
    unused."""
    total = 0.0
    n = imgs.shape[0]
    for r in range(0, n, ROW_BLOCK):
        loss = cross_entropy_sum(model(imgs[r:r + ROW_BLOCK], precision),
                                 labels[r:r + ROW_BLOCK]) / n
        loss.backward()
        total += float(loss.detach())
    return total


# ---------------------------------------------------------------------------
# operations and bytes, from shapes
# ---------------------------------------------------------------------------
def _conv_shapes(image_size, cfg=CFG):
    """(h, w, c_in, c_out) of each conv, and (h, w, c) of each pool input."""
    convs, pools = [], []
    s, c_in = image_size, 3
    for v in cfg:
        if v == "M":
            pools.append((s, s, c_in))
            s //= 2
        else:
            convs.append((s, s, c_in, v))
            c_in = v
    return convs, pools, s, c_in


def forward_flops_per_image(image_size=448, num_classes=200):
    convs, _, s, c = _conv_shapes(image_size)
    flops = sum(2 * h * w * ci * co * 9 for h, w, ci, co in convs)
    flops += 2 * s * s * c * c  # the Gram
    flops += 2 * c * c * num_classes  # the classifier
    return flops


def train_flops_per_image(image_size=448, num_classes=200):
    """Forward x 3 (forward, data and weight gradients), less the first
    conv's data gradient, which no one needs; no recomputation."""
    convs, _, _, _ = _conv_shapes(image_size)
    h, w, ci, co = convs[0]
    return 3 * forward_flops_per_image(image_size, num_classes) - 2 * h * w * ci * co * 9


def _pool_fwd(batch, image_size):
    """Pre-ReLU bf16 input read, pooled bf16 output and uint8 code written."""
    _, pools, _, _ = _conv_shapes(image_size)
    n = sum(h * w * c for h, w, c in pools)
    return batch * (2 * n + 3 * n // 4), 0, len(pools)


def _pool_bwd(batch, image_size):
    """Output gradient, code and pooled output read; input gradient written."""
    _, pools, _, _ = _conv_shapes(image_size)
    n = sum(h * w * c for h, w, c in pools)
    return batch * (5 * n // 4 + 2 * n), 0, len(pools)


def _gram(batch, image_size):
    """bf16 X [B, HW, C] read, float32 [B, C, C] written; 2 HW C^2 a image."""
    _, _, s, c = _conv_shapes(image_size)
    return batch * (2 * s * s * c + 4 * c * c), batch * 2 * s * s * c * c, 1


# kernel-name substring -> f(batch per rank, image size) = (bytes, operations,
# launches) of one train step
KERNEL_WORK = {"pool_fwd_kernel": _pool_fwd, "pool_bwd_kernel": _pool_bwd,
               "gram_signed_sqrt": _gram}
