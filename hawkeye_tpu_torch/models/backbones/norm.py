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

``GroupedBatchNorm`` is the counterpart of the JAX package's module of that
name, for the fused multi-view passes (NTS-Net's global + parts pass, S3N's
views): in train mode each contiguous batch group is normalised with its own
statistics and the running averages fold one group after another, in group
order, as separate passes would. Its parameters and buffers are
``BatchNorm``'s, and with one group it is ``BatchNorm``.
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


class GroupedBatchNorm(BatchNorm):
    """``BatchNorm`` whose train-mode statistics are per batch group.

    ``groups`` (set by the caller before a forward, as the ResNet's
    ``bn_groups`` does) is an int G, G equal contiguous groups, or a tuple
    of the groups' sizes, such as ``(B, B*M)``; 1 is plain ``BatchNorm``.
    Eval mode ignores it."""

    def __init__(self, num_features, momentum=0.9, eps=1e-5):
        super().__init__(num_features, momentum, eps)
        self.groups = 1

    def forward(self, x):
        if not self.training or self.groups == 1:
            return super().forward(x)
        n = x.shape[0]
        if isinstance(self.groups, (tuple, list)):
            sizes = tuple(int(s) for s in self.groups)
            if sum(sizes) != n:
                raise ValueError(f"group sizes {sizes} do not sum to batch {n}")
        else:
            g = int(self.groups)
            if n % g:
                raise ValueError(f"batch {n} not divisible by bn groups {g}")
            sizes = (n // g,) * g
        ys, off = [], 0
        for s in sizes:  # contiguous batch slices, folded in group order
            ys.append(super().forward(x[off:off + s]))
            off += s
        return torch.cat(ys)
