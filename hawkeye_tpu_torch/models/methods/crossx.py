"""CrossX: cross-layer multi-excitation feature learning.

Counterpart of ``hawkeye_tpu/models/methods/crossx.py`` (reference
``model/methods/CrossX.py``): a ResNet-50 trunk built inline with flax's
top-level names (``conv1``, ``bn1``, ``layer{i}_{j}``; no ``backbone``),
whose last block of stages 3 and 4 (``layer3_5``, ``layer4_2``) is an
``MEBottleneck``: P squeeze-and-excitation branches (``me.fc1_i`` of width
``max(C // 256, 1)``, ``me.fc2_i``, in the trunk's dtype) over the
pre-residual output, each part ``relu(excited + identity)``. Fusion, per
part: ``conv2_i`` (1x1 to 1024) on the stage-4 part, ``resize_nearest`` to
the stage-3 size, added to the stage-3 part, ``conv3_i`` (3x3) and
``bn3_i``. Three float32 heads: ``fc_plty`` on the max-pooled stage-3
parts, ``fc_ulti`` on the mean-pooled stage-4 parts and ``fc_cmbn`` on the
mean-pooled fused maps; ``logits`` is their sum, and the per-head logits
and pooled parts go to the loss. ``num_parts == 1`` is the plain ResNet-50
with ``fc_ulti``.

The trunk is NCHW in channels-last memory like the port's ResNet, and takes
NHWC input. The heads compute in their parameters' dtype (float32; float64
in a model cast to float64).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.resample import resize_nearest
from ...registry import MODEL
from ..backbones.norm import BatchNorm
from ..backbones.resnet import Bottleneck, _conv
from .osme import dense

_BN = dict(momentum=0.9, eps=1e-5)


class MELayer(nn.Module):
    """P excitations of one squeeze: ``x * sigmoid(fc2_i(relu(fc1_i(z))))``."""

    def __init__(self, channels, nparts, reduction=256, dtype=torch.bfloat16):
        super().__init__()
        self.nparts = int(nparts)
        self.dtype = dtype
        hidden = max(channels // reduction, 1)
        for i in range(self.nparts):
            self.add_module(f"fc1_{i}", nn.Linear(channels, hidden))
            self.add_module(f"fc2_{i}", nn.Linear(hidden, channels))

    def forward(self, x):
        z = x.mean(dim=(2, 3))
        parts = []
        for i in range(self.nparts):
            m = F.relu(dense(getattr(self, f"fc1_{i}"), z, self.dtype))
            m = torch.sigmoid(dense(getattr(self, f"fc2_{i}"), m, self.dtype))
            parts.append(x * m[:, :, None, None])
        return parts


class MEBottleneck(nn.Module):
    """A bottleneck (stride 1, no downsample) whose pre-residual output also
    feeds P excitation branches: returns ``relu(out + x)`` and the parts
    ``relu(excited_i + x)``."""

    def __init__(self, c_in, filters, nparts, reduction=256, dtype=torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(c_in, filters, 1, bias=False)
        self.bn1 = BatchNorm(filters, **_BN)
        self.conv2 = nn.Conv2d(filters, filters, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm(filters, **_BN)
        self.conv3 = nn.Conv2d(filters, filters * 4, 1, bias=False)
        self.bn3 = BatchNorm(filters * 4, **_BN)
        self.me = MELayer(filters * 4, nparts, reduction, dtype)

    def forward(self, x):
        out = F.relu(self.bn1(_conv(self.conv1, x, self.dtype)))
        out = F.relu(self.bn2(_conv(self.conv2, out, self.dtype)))
        out = self.bn3(_conv(self.conv3, out, self.dtype))
        parts = [F.relu(p + x) for p in self.me(out)]
        return F.relu(out + x), parts


class CrossXNet(nn.Module):
    def __init__(self, num_classes, num_parts=2, dtype=torch.bfloat16):
        super().__init__()
        self.num_parts = int(num_parts)
        self.dtype = dtype
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = BatchNorm(64, **_BN)
        self.block_names = []
        c_in, filters = 64, 64
        for i, num_blocks in enumerate((3, 4, 6, 3)):
            stride = 1 if i == 0 else 2
            me_stage = i >= 2 and self.num_parts > 1
            for j in range(num_blocks):
                name = f"layer{i + 1}_{j}"
                if me_stage and j == num_blocks - 1:
                    block = MEBottleneck(c_in, filters, self.num_parts, 256, dtype)
                else:
                    blk_stride = stride if j == 0 else 1
                    down = j == 0 and (blk_stride != 1 or c_in != filters * 4)
                    block = Bottleneck(c_in, filters, blk_stride, down, dtype=dtype,
                                       **_BN)
                self.add_module(name, block)
                self.block_names.append(name)
                c_in = filters * 4
            filters *= 2
        if self.num_parts == 1:
            self.fc_ulti = nn.Linear(2048, num_classes)
            return
        for i in range(self.num_parts):
            self.add_module(f"conv2_{i}", nn.Conv2d(2048, 1024, 1, bias=False))
            self.add_module(f"conv3_{i}", nn.Conv2d(1024, 1024, 3, 1, 1, bias=False))
            self.add_module(f"bn3_{i}", BatchNorm(1024, **_BN))
        self.fc_plty = nn.Linear(self.num_parts * 1024, num_classes)
        self.fc_ulti = nn.Linear(self.num_parts * 2048, num_classes)
        self.fc_cmbn = nn.Linear(self.num_parts * 1024, num_classes)

    def forward(self, x):
        # NHWC in; the NCHW view of channels-last memory is what cuDNN takes
        x = x.to(self.dtype).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        x = F.relu(self.bn1(_conv(self.conv1, x, self.dtype)))
        x = F.max_pool2d(x, 3, 2, 1)
        plty_parts = ulti_parts = None
        for name in self.block_names:
            block = getattr(self, name)
            if isinstance(block, MEBottleneck):
                x, parts = block(x)
                if name.startswith("layer3"):
                    plty_parts = parts
                else:
                    ulti_parts = parts
            else:
                x = block(x)

        head = self.fc_ulti.weight.dtype  # float32 unless the model is cast
        if self.num_parts == 1:
            return {"logits": self.fc_ulti(x.mean(dim=(2, 3)).to(head))}

        plty_hw = plty_parts[0].shape[2]
        cmbn = []
        for i in range(self.num_parts):
            u = _conv(getattr(self, f"conv2_{i}"), ulti_parts[i], self.dtype)
            u = resize_nearest(u.permute(0, 2, 3, 1), plty_hw, plty_hw)
            f = _conv(getattr(self, f"conv3_{i}"),
                      plty_parts[i] + u.permute(0, 3, 1, 2), self.dtype)
            cmbn.append(getattr(self, f"bn3_{i}")(f).mean(dim=(2, 3)).to(head))
        plty = [p.amax(dim=(2, 3)).to(head) for p in plty_parts]
        ulti = [p.mean(dim=(2, 3)).to(head) for p in ulti_parts]
        xp = self.fc_plty(torch.cat(plty, dim=1))
        xf = self.fc_ulti(torch.cat(ulti, dim=1))
        xc = self.fc_cmbn(torch.cat(cmbn, dim=1))
        return {"logits": xf + xp + xc, "logits_ulti": xf, "logits_plty": xp,
                "logits_cmbn": xc, "ulti_parts": torch.stack(ulti, dim=1),
                "plty_parts": torch.stack(plty, dim=1),
                "cmbn_parts": torch.stack(cmbn, dim=1)}


@MODEL.register(name="CrossX")
def build_crossx(config):
    return CrossXNet(num_classes=int(config.get("num_classes", 200)),
                     num_parts=int(config.get("num_parts", 2)))
