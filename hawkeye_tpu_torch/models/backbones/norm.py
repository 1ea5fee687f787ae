"""BatchNorm with the JAX package's (flax) semantics.

Counterpart of ``flax.linen.BatchNorm`` as the JAX ResNet uses it, and of
``hawkeye_tpu/models/backbones/norm.py`` with ``groups=1``:

* train mode normalises with the batch statistics in float32 and folds the
  *biased* batch variance into the running variance (``torch.nn.BatchNorm2d``
  folds the unbiased one);
* flax's ``momentum=0.9`` means ``s' = 0.9*s + 0.1*v`` (torch momentum 0.1);
* eps 1e-5; float32 ``weight``/``bias`` (flax ``scale``/``bias``) and float32
  running statistics; the output keeps the input's dtype.

Train mode runs ``aten.native_batch_norm`` without running statistics: one
normalising kernel (the channels-last CUDA kernels on the card) that returns
the batch mean and ``invstd``, from which the float32 buffers are updated
with ``var = invstd^-2 - eps``. It has no ``num_batches_tracked``; the weight
bridge carries ``running_mean``/``running_var`` as flax's
``batch_stats/{mean,var}``.

Not ported yet: per-group statistics (``groups > 1``, ``group_sizes``) for
the fused multi-view passes of S3N and NTS-Net.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


class BatchNorm(nn.Module):
    def __init__(self, num_features, momentum=0.9, eps=1e-5):
        super().__init__()
        self.momentum = float(momentum)
        # flax folds m*s + (1-m)*v with 1-m computed in float32
        self._rate = float(np.float32(1.0) - np.float32(momentum))
        self.eps = float(eps)
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        """``x``: NCHW (channels-last memory on the trunk), any float dtype."""
        if not self.training:
            return torch.ops.aten.native_batch_norm(
                x, self.weight, self.bias, self.running_mean, self.running_var,
                False, 0.0, self.eps)[0]
        y, mean, invstd = torch.ops.aten.native_batch_norm(
            x, self.weight, self.bias, None, None, True, 0.0, self.eps)
        with torch.no_grad():
            var = invstd.pow(-2).sub_(self.eps)
            self.running_mean.mul_(self.momentum).add_(mean, alpha=self._rate)
            self.running_var.mul_(self.momentum).add_(var, alpha=self._rate)
        return y
