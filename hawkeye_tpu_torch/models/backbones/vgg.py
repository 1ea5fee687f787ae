"""VGG backbone family (PyTorch, NHWC at the interface).

Counterpart of ``hawkeye_tpu/models/backbones/vgg.py``: torchvision-style
A/B/D/E conv trunks registered as ``vgg11/13/16/19`` and, with BatchNorm
after every conv, ``vgg11_bn/13_bn/16_bn/19_bn``. The forward takes NHWC
float input like the JAX model and returns the same stage dict, in NHWC:
``features`` (the ReLU map that enters the last max pool), ``pooled_features``
(after it), ``pool`` and, with ``num_classes > 0``, ``logits``.

Parameters are float32 (``param_dtype``) and named after torchvision's
``features.<idx>`` (the index the JAX model tracks as ``layer_idx``): a conv
at ``features.<i>``, its BatchNorm at ``<i+1>`` and its ReLU at ``<i+2>``,
which the JAX model names ``conv<i>`` and ``bn<i+1>``. Compute runs in
``dtype`` (bfloat16 by default) by explicit casts, so a float32 head can sit
on top. The trunk runs in ``torch.channels_last``: the NHWC input viewed as
NCHW is already that layout, the NHWC pool op takes ``x.permute(0, 2, 3, 1)``
without a copy, and cuDNN gets its NHWC path.

BatchNorm is the JAX package's flax semantics (``backbones/norm.py``: biased
variance folded with momentum 0.9, float32 statistics, the output in the
compute dtype); train or eval mode is ``module.training``;
``bn_cross_replica_axis`` (any value but None) takes the statistics over the
global batch of every process.

Classifier (``num_classes > 0``): the map after the last pool, average-pooled
to 7x7 over equal windows, flattened in NHWC order ``(h, w, c)`` as the JAX
model flattens it (``models/weights.py`` permutes torchvision's NCHW-ordered
``classifier.0`` to it), then ``fc0`` (4096), ReLU, dropout, ``fc3`` (4096),
ReLU, dropout, ``fc6``, all in float32; ``pool`` is then the flattened map.
Train-mode dropout draws its masks from the ``generator`` the caller passes
(the Trainer's ``model_generator``).

Options, each neutral in value:

* ``efficient_pool``: a conv (and its BatchNorm) followed by a max pool
  defers its ReLU into ``ops.pool.relu_maxpool2x2`` (the CUDA pool kernels
  on the card), on the BN path too.
* ``remat_first``: the first conv+ReLU runs under ``torch.utils.checkpoint``.
* ``fast_dgrad``: the 64->64 convs take ``ops.conv.conv3x3_same_fast_dgrad``
  (a forward-form data gradient).

``remat_first`` and ``fast_dgrad`` are off where BatchNorm is on, as in the
JAX model.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...ops.conv import conv3x3_same_fast_dgrad
from ...ops.pool import relu_maxpool2x2
from ...registry import BACKBONE
from ...utils.tensors import dropout
from .norm import BatchNorm

# torchvision cfgs: number = conv out-channels, "M" = 2x2 maxpool.
_VGG_CFGS = {
    "A": [64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "B": [64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"],
    "D": [64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
          512, 512, 512, "M"],
    "E": [64, 64, "M", 128, 128, "M", 256, 256, 256, 256, "M", 512, 512, 512, 512,
          "M", 512, 512, 512, 512, "M"],
}


class VGG(nn.Module):
    def __init__(self, cfg, batch_norm=False, num_classes=0, dropout_rate=0.5,
                 dtype=torch.bfloat16, param_dtype=torch.float32,
                 bn_cross_replica_axis=None, efficient_pool=True,
                 remat_first=True, fast_dgrad=False):
        super().__init__()
        self.cfg = list(cfg)
        self.batch_norm = bool(batch_norm)
        self.dtype = dtype
        self.dropout_rate = float(dropout_rate)
        self.efficient_pool = efficient_pool
        self.remat_first = remat_first and not self.batch_norm
        self.fast_dgrad = fast_dgrad and not self.batch_norm
        self.features = nn.ModuleDict()
        layer_idx, c_in = 0, 3  # RGB
        for v in self.cfg:
            if v == "M":
                layer_idx += 1
                continue
            self.features[str(layer_idx)] = nn.Conv2d(c_in, v, 3, padding=1,
                                                      dtype=param_dtype)
            layer_idx += 1
            if self.batch_norm:
                self.features[str(layer_idx)] = BatchNorm(
                    v, cross_replica=bn_cross_replica_axis is not None)
                layer_idx += 1
            c_in = v
            layer_idx += 1  # relu
        self.out_channels = c_in
        self.num_classes = int(num_classes)
        if self.num_classes > 0:
            self.fc0 = nn.Linear(49 * c_in, 4096, dtype=param_dtype)
            self.fc3 = nn.Linear(4096, 4096, dtype=param_dtype)
            self.fc6 = nn.Linear(4096, self.num_classes, dtype=param_dtype)

    def _conv(self, x, idx):
        conv = self.features[str(idx)]
        w = conv.weight.to(self.dtype)
        if self.fast_dgrad and conv.in_channels == 64 and conv.out_channels == 64:
            return conv3x3_same_fast_dgrad(x, w) + conv.bias.to(self.dtype).view(1, -1, 1, 1)
        return F.conv2d(x, w, conv.bias.to(self.dtype), padding=1)

    def _conv_relu0(self, x):
        return F.relu(self._conv(x, 0))

    def forward(self, x, generator=None):
        # NHWC in; the NCHW view of NHWC memory is channels_last
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        n_pools = self.cfg.count("M")
        pool_seen = 0
        layer_idx = 0
        pending = None  # pre-ReLU conv output whose ReLU joins the next pool
        pre_last_pool = None
        for ci, v in enumerate(self.cfg):
            if v == "M":
                pool_seen += 1
                if pending is not None:
                    if pool_seen == n_pools:
                        pre_last_pool = F.relu(pending)
                    x = relu_maxpool2x2(pending.permute(0, 2, 3, 1)).permute(
                        0, 3, 1, 2)
                    pending = None
                else:
                    if pool_seen == n_pools:
                        pre_last_pool = x
                    x = F.max_pool2d(x, 2, 2)
                layer_idx += 1
            elif self.remat_first and layer_idx == 0:
                if torch.is_grad_enabled():
                    x = checkpoint(self._conv_relu0, x, use_reentrant=False)
                else:
                    x = self._conv_relu0(x)
                layer_idx += 2
            else:
                x = self._conv(x, layer_idx)
                layer_idx += 1
                if self.batch_norm:
                    x = self.features[str(layer_idx)](x)
                    layer_idx += 1
                if (self.efficient_pool and ci + 1 < len(self.cfg)
                        and self.cfg[ci + 1] == "M"):
                    pending = x
                else:
                    x = F.relu(x)
                layer_idx += 1
        pooled = x.permute(0, 2, 3, 1)
        stages = {"features": pre_last_pool.permute(0, 2, 3, 1),
                  "pooled_features": pooled}
        if self.num_classes == 0:
            stages["pool"] = pooled.float().mean(dim=(1, 2))
            return stages
        b, h, w, c = pooled.shape
        if (h, w) != (7, 7):  # adaptive average pool to 7x7, equal windows
            if h % 7 or w % 7:
                raise ValueError(f"the VGG classifier needs spatial dims "
                                 f"divisible by 7, got {h}x{w}")
            pooled = pooled.reshape(b, 7, h // 7, 7, w // 7, c).mean(dim=(2, 4))
        head = self.fc0.weight.dtype
        flat = pooled.reshape(b, -1).to(torch.promote_types(head, torch.float32))
        stages["pool"] = flat
        drop = self.training and self.dropout_rate > 0.0
        if drop and generator is None:
            raise ValueError("the VGG classifier's train forward draws its dropout "
                             "masks from a generator: pass generator=")
        y = F.relu(self.fc0(flat))
        y = dropout(y, self.dropout_rate, generator) if drop else y
        y = F.relu(self.fc3(y))
        y = dropout(y, self.dropout_rate, generator) if drop else y
        stages["logits"] = self.fc6(y)
        return stages


_VGG_DEFS = {
    "vgg11": ("A", False), "vgg11_bn": ("A", True),
    "vgg13": ("B", False), "vgg13_bn": ("B", True),
    "vgg16": ("D", False), "vgg16_bn": ("D", True),
    "vgg19": ("E", False), "vgg19_bn": ("E", True),
}


def _make_vgg_factory(name):
    cfg_key, bn = _VGG_DEFS[name]

    def factory(num_classes=0, **kwargs):
        return VGG(_VGG_CFGS[cfg_key], batch_norm=bn, num_classes=num_classes,
                   **kwargs)

    factory.__name__ = name
    return factory


for _name in _VGG_DEFS:
    BACKBONE.register(_make_vgg_factory(_name), name=_name)
