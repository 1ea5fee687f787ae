"""ResNet backbone family (PyTorch, NHWC at the interface).

Counterpart of ``hawkeye_tpu/models/backbones/resnet.py``: ResNet v1.5
(stride on the bottleneck's 3x3) with ``BasicBlock``/``Bottleneck``,
``groups``/``width_per_group`` for the ResNeXt and Wide variants, all nine
registrations, and ``feature_dim``. The forward takes NHWC float input like
the JAX model and returns the same stage dict, in NHWC: ``stem`` (after the
max pool), ``c2``..``c5`` (layer1..layer4), ``pool`` (spatial mean, float32)
and ``logits`` when ``num_classes > 0``.

Conventions of the port's VGG: float32 parameters with compute in ``dtype``
(bfloat16 by default) by explicit casts, and a trunk in
``torch.channels_last``. BatchNorm has the JAX semantics
(``backbones/norm.py``); train or eval mode is ``module.training``.
Submodules carry the flax names (``conv1``, ``bn1``, ``layer1_0``,
``downsample_conv``, ``downsample_bn``, ``fc``), so the weight bridge is a
plain name map.

``stem_space_to_depth`` is accepted and computes the plain 7x7/2 conv: the
JAX option is an MXU layout of the same function with the same
``(7, 7, 3, 64)`` parameter.

Per-view BatchNorm for fused multi-view passes: with ``grouped_bn`` the
norm layers are ``GroupedBatchNorm`` and ``forward(x, bn_groups=...)``
takes an int G (equal contiguous groups) or a tuple of group sizes (NTS-Net's
``(B, B*M)``); ``bn_groups`` other than 1 without ``grouped_bn`` raises. The
parameters and buffers are the same either way.

``bn_cross_replica_axis`` (any value but None) gives every norm layer
global-batch statistics over the processes of a ``torch.distributed``
world (``backbones/norm.py``); the Trainer switches them on whenever it runs
in more than one process, as the JAX train step's statistics span the whole
sharded batch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ...registry import BACKBONE
from .norm import BatchNorm, GroupedBatchNorm, batch_norm_train


def _conv(conv, x, dtype):
    """``conv`` applied to NCHW ``x`` in ``dtype``, as a flax conv with that
    ``dtype`` computes: input, weight and bias cast to it, the weight in
    channels-last memory."""
    w = conv.weight.to(dtype, memory_format=torch.channels_last)
    b = None if conv.bias is None else conv.bias.to(dtype)
    return F.conv2d(x.to(dtype), w, b, conv.stride, conv.padding, 1, conv.groups)


class BasicBlock(nn.Module):
    """Two 3x3 convs. Expansion 1."""

    expansion = 1

    def __init__(self, c_in, filters, stride=1, downsample=False, groups=1,
                 base_width=64, dtype=torch.bfloat16, norm=BatchNorm, **bn):
        super().__init__()
        self.dtype = dtype
        self.conv1 = nn.Conv2d(c_in, filters, 3, stride, 1, bias=False)
        self.bn1 = norm(filters, **bn)
        self.conv2 = nn.Conv2d(filters, filters, 3, 1, 1, bias=False)
        self.bn2 = norm(filters, **bn)
        self.downsample = downsample
        if downsample:
            self.downsample_conv = nn.Conv2d(c_in, filters, 1, stride, bias=False)
            self.downsample_bn = norm(filters, **bn)

    def forward(self, x):
        out = F.relu(self.bn1(_conv(self.conv1, x, self.dtype)))
        out = self.bn2(_conv(self.conv2, out, self.dtype))
        identity = x
        if self.downsample:
            identity = self.downsample_bn(_conv(self.downsample_conv, x, self.dtype))
        return F.relu(out + identity)


class Bottleneck(nn.Module):
    """1x1 reduce, 3x3 (stride here = ResNet v1.5), 1x1 expand. Expansion 4."""

    expansion = 4

    def __init__(self, c_in, filters, stride=1, downsample=False, groups=1,
                 base_width=64, dtype=torch.bfloat16, norm=BatchNorm, **bn):
        super().__init__()
        self.dtype = dtype
        width = int(filters * (base_width / 64.0)) * groups
        c_out = filters * self.expansion
        self.conv1 = nn.Conv2d(c_in, width, 1, bias=False)
        self.bn1 = norm(width, **bn)
        self.conv2 = nn.Conv2d(width, width, 3, stride, 1, groups=groups, bias=False)
        self.bn2 = norm(width, **bn)
        self.conv3 = nn.Conv2d(width, c_out, 1, bias=False)
        self.bn3 = norm(c_out, **bn)
        self.downsample = downsample
        if downsample:
            self.downsample_conv = nn.Conv2d(c_in, c_out, 1, stride, bias=False)
            self.downsample_bn = norm(c_out, **bn)

    def forward(self, x):
        out = F.relu(self.bn1(_conv(self.conv1, x, self.dtype)))
        out = F.relu(self.bn2(_conv(self.conv2, out, self.dtype)))
        out = self.bn3(_conv(self.conv3, out, self.dtype))
        identity = x
        if self.downsample:
            identity = self.downsample_bn(_conv(self.downsample_conv, x, self.dtype))
        return F.relu(out + identity)


class ResNet(nn.Module):
    """ResNet v1.5 trunk; ``forward(x, bn_groups=1)`` returns the stage dict."""

    def __init__(self, block_cls, stage_sizes, num_classes=0, groups=1,
                 width_per_group=64, dtype=torch.bfloat16, bn_momentum=0.9,
                 bn_epsilon=1e-5, strides=(1, 2, 2, 2),
                 stem_space_to_depth=False, grouped_bn=False,
                 bn_cross_replica_axis=None):
        super().__init__()
        self.dtype = dtype
        self.grouped_bn = bool(grouped_bn)
        norm = GroupedBatchNorm if grouped_bn else BatchNorm
        bn = dict(momentum=bn_momentum, eps=bn_epsilon,
                  cross_replica=bn_cross_replica_axis is not None)
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False)
        self.bn1 = norm(64, **bn)
        self.stage_names = []
        c_in, filters = 64, 64
        for i, (num_blocks, stride) in enumerate(zip(stage_sizes, strides)):
            names = []
            for j in range(num_blocks):
                blk_stride = stride if j == 0 else 1
                needs_down = j == 0 and (
                    blk_stride != 1 or c_in != filters * block_cls.expansion)
                name = f"layer{i + 1}_{j}"
                self.add_module(name, block_cls(
                    c_in, filters, blk_stride, needs_down, groups,
                    width_per_group, dtype, norm, **bn))
                names.append(name)
                c_in = filters * block_cls.expansion
            self.stage_names.append(names)
            filters *= 2
        self.out_channels = c_in
        self.strides = tuple(strides[:len(stage_sizes)])
        self.fc = (nn.Linear(c_in, num_classes, dtype=torch.float32)
                   if num_classes > 0 else None)

    def feature_size(self, image_size):
        """Side of the last stage's map for a square input of ``image_size``
        pixels: the 7x7/2 stem conv and the 3x3/2 max pool (padding 3 and
        1), then each stage's stride (its 3x3 conv has padding 1)."""
        s = (int(image_size) - 1) // 2 + 1
        s = (s - 1) // 2 + 1
        for stride in self.strides:
            s = (s - 1) // stride + 1
        return s

    def forward(self, x, bn_groups=1):
        if self.grouped_bn:
            for m in self.modules():
                if isinstance(m, GroupedBatchNorm):
                    m.groups = bn_groups
        elif bn_groups != 1:
            raise ValueError("bn_groups other than 1 needs grouped_bn=True")
        # NHWC in; the NCHW view of channels-last memory is what cuDNN takes
        x = x.to(self.dtype).permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        x = F.relu(self.bn1(_conv(self.conv1, x, self.dtype)))
        x = F.max_pool2d(x, 3, 2, 1)  # -inf padding, as flax's max_pool
        stages = {"stem": x.permute(0, 2, 3, 1)}
        for i, names in enumerate(self.stage_names):
            for name in names:
                x = getattr(self, name)(x)
            stages[f"c{i + 2}"] = x.permute(0, 2, 3, 1)
        # mean in the compute dtype, then float32, as jnp.mean(...).astype
        stages["pool"] = x.mean(dim=(2, 3)).float()
        if self.fc is not None:
            stages["logits"] = self.fc(stages["pool"])
        return stages


def _stack(tensors):
    return tensors[0] if len(tensors) == 1 else torch.cat(tensors)


def _stacked_conv(convs, x, dtype):
    """The E convs (same shape) of E stacked trunks as one grouped conv."""
    c = convs[0]
    w = _stack([m.weight.to(dtype) for m in convs]).contiguous(
        memory_format=torch.channels_last)
    return F.conv2d(x.to(dtype), w, None, c.stride, c.padding, 1, c.groups * len(convs))


def _stacked_bn(bns, x, fold):
    """The E norm layers of E stacked trunks as one call; in train mode each
    layer folds its own channels' statistics unless ``fold`` is off."""
    b0 = bns[0]
    weight = _stack([b.weight for b in bns])
    bias = _stack([b.bias for b in bns])
    if not b0.training:
        return torch.ops.aten.native_batch_norm(
            x, weight, bias, _stack([b.running_mean for b in bns]),
            _stack([b.running_var for b in bns]), False, 0.0, b0.eps)[0]
    y, mean, var = batch_norm_train(x, weight, bias, b0.eps, b0.cross_replica)
    if fold:
        c = b0.weight.shape[0]
        for i, b in enumerate(bns):
            b.fold(mean[i * c:(i + 1) * c], var[i * c:(i + 1) * c])
    return y


def _stacked_block(blocks, x, dtype, fold):
    b0 = blocks[0]

    def conv_bn(conv, bn, inp):
        y = _stacked_conv([getattr(b, conv) for b in blocks], inp, dtype)
        return _stacked_bn([getattr(b, bn) for b in blocks], y, fold)

    out = F.relu(conv_bn("conv1", "bn1", x))
    if isinstance(b0, Bottleneck):
        out = F.relu(conv_bn("conv2", "bn2", out))
        out = conv_bn("conv3", "bn3", out)
    else:
        out = conv_bn("conv2", "bn2", out)
    identity = conv_bn("downsample_conv", "downsample_bn", x) if b0.downsample else x
    return F.relu(out + identity)


def stacked_forward(trunks, x, fold=True):
    """E ResNet trunks of one architecture (plain BatchNorm) as one pass.

    ``x``: NHWC ``[B, H, W, 3E]``, trunk ``e``'s view in channels
    ``3e..3e+2``. Returns the stage dict of ``ResNet.forward`` without
    ``pool``, each map ``[B, h, w, E*C]`` with trunk ``e``'s channels
    ``e*C..``. Train or eval mode is the trunks'; ``fold=False`` leaves the
    running statistics as they are (a forward whose statistics are
    discarded)."""
    r0 = trunks[0]
    dtype = r0.dtype
    x = x.to(dtype).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    x = _stacked_conv([t.conv1 for t in trunks], x, dtype)
    x = F.relu(_stacked_bn([t.bn1 for t in trunks], x, fold))
    x = F.max_pool2d(x, 3, 2, 1)
    stages = {"stem": x.permute(0, 2, 3, 1)}
    for i, names in enumerate(r0.stage_names):
        for name in names:
            x = _stacked_block([getattr(t, name) for t in trunks], x, dtype, fold)
        stages[f"c{i + 2}"] = x.permute(0, 2, 3, 1)
    return stages


_RESNET_DEFS = {
    # name: (block, stage_sizes, groups, width_per_group)
    "resnet18": (BasicBlock, (2, 2, 2, 2), 1, 64),
    "resnet34": (BasicBlock, (3, 4, 6, 3), 1, 64),
    "resnet50": (Bottleneck, (3, 4, 6, 3), 1, 64),
    "resnet101": (Bottleneck, (3, 4, 23, 3), 1, 64),
    "resnet152": (Bottleneck, (3, 8, 36, 3), 1, 64),
    "resnext50_32x4d": (Bottleneck, (3, 4, 6, 3), 32, 4),
    "resnext101_32x8d": (Bottleneck, (3, 4, 23, 3), 32, 8),
    "wide_resnet50_2": (Bottleneck, (3, 4, 6, 3), 1, 128),
    "wide_resnet101_2": (Bottleneck, (3, 4, 23, 3), 1, 128),
}


def _make_resnet_factory(name):
    block, sizes, groups, wpg = _RESNET_DEFS[name]

    def factory(num_classes=0, **kwargs):
        return ResNet(block, sizes, num_classes=num_classes, groups=groups,
                      width_per_group=wpg, **kwargs)

    factory.__name__ = name
    return factory


for _name in _RESNET_DEFS:
    BACKBONE.register(_make_resnet_factory(_name), name=_name)


def feature_dim(name):
    """Channel count of the c5 feature map for a registered resnet."""
    block, _, _, _ = _RESNET_DEFS[name]
    return 512 * block.expansion
