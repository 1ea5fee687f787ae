"""VGG backbone family (PyTorch, NHWC at the interface).

Counterpart of ``hawkeye_tpu/models/backbones/vgg.py``: torchvision-style
A/B/D/E conv trunks registered as ``vgg11/13/16/19``. The forward takes NHWC
float input like the JAX model and returns the same stage dict, in NHWC:
``features`` (the ReLU map that enters the last max pool), ``pooled_features``
(after it) and ``pool`` (spatial mean, float32).

Parameters are float32 (``param_dtype``) and named ``features.<idx>`` after
the torchvision index the JAX model tracks as ``layer_idx``; compute runs in
``dtype`` (bfloat16 by default) by explicit casts, so a float32 head can sit
on top. The trunk runs in ``torch.channels_last``: the NHWC input viewed as
NCHW is already that layout, the NHWC pool op takes ``x.permute(0, 2, 3, 1)``
without a copy, and cuDNN gets its NHWC path.

Options, both neutral in value:

* ``efficient_pool``: a conv followed by a max pool defers its ReLU into
  ``ops.pool.relu_maxpool2x2`` (the CUDA pool kernels on the card).
* ``remat_first``: the first conv+ReLU runs under ``torch.utils.checkpoint``.

Not ported yet: the ``_bn`` variants, ``fast_dgrad`` and the 4096-wide
classifier (``num_classes > 0``); asking for them raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ...ops.pool import relu_maxpool2x2
from ...registry import BACKBONE

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
    def __init__(self, cfg, batch_norm=False, num_classes=0,
                 dtype=torch.bfloat16, param_dtype=torch.float32,
                 efficient_pool=True, remat_first=True, fast_dgrad=False):
        super().__init__()
        if batch_norm or num_classes or fast_dgrad:
            raise NotImplementedError(
                "VGG batch_norm, fast_dgrad and the classifier head "
                "(num_classes > 0) are not ported yet")
        self.cfg = list(cfg)
        self.dtype = dtype
        self.efficient_pool = efficient_pool
        self.remat_first = remat_first
        self.features = nn.ModuleDict()
        layer_idx, c_in = 0, 3  # RGB
        for v in self.cfg:
            if v == "M":
                layer_idx += 1
            else:
                self.features[str(layer_idx)] = nn.Conv2d(
                    c_in, v, 3, padding=1, dtype=param_dtype)
                c_in = v
                layer_idx += 2  # conv, relu
        self.out_channels = c_in

    def _conv(self, x, idx):
        conv = self.features[str(idx)]
        return F.conv2d(x, conv.weight.to(self.dtype), conv.bias.to(self.dtype),
                        padding=1)

    def _conv_relu0(self, x):
        return F.relu(self._conv(x, 0))

    def forward(self, x):
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
                if (self.efficient_pool and ci + 1 < len(self.cfg)
                        and self.cfg[ci + 1] == "M"):
                    pending = x
                else:
                    x = F.relu(x)
                layer_idx += 1
        pooled = x.permute(0, 2, 3, 1)
        return {
            "features": pre_last_pool.permute(0, 2, 3, 1),
            "pooled_features": pooled,
            "pool": pooled.float().mean(dim=(1, 2)),
        }


_VGG_DEFS = {"vgg11": "A", "vgg13": "B", "vgg16": "D", "vgg19": "E"}


def _make_vgg_factory(name):
    def factory(num_classes=0, **kwargs):
        return VGG(_VGG_CFGS[_VGG_DEFS[name]], num_classes=num_classes, **kwargs)

    factory.__name__ = name
    return factory


for _name in _VGG_DEFS:
    BACKBONE.register(_make_vgg_factory(_name), name=_name)
