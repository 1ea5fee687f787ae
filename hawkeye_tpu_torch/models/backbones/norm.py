"""BatchNorm with the JAX package's (flax) semantics.

Counterpart of ``flax.linen.BatchNorm`` as the JAX ResNet uses it, and of
``hawkeye_tpu/models/backbones/norm.py`` with ``groups=1``:

* train mode normalises with the batch statistics in float32 and folds the
  *biased* batch variance into the running variance (``torch.nn.BatchNorm2d``
  folds the unbiased one);
* flax's ``momentum=0.9`` means ``s' = 0.9*s + 0.1*v`` (torch momentum 0.1),
  with ``1 - momentum`` as ``flax.linen.BatchNorm`` computes it, a Python
  float (``0.1`` in float32 statistics); ``GroupedBatchNorm``, as the JAX
  package's, computes it in float32 (``0.100000024``);
* eps 1e-5; float32 ``weight``/``bias`` (flax ``scale``/``bias``) and float32
  running statistics; the output keeps the input's dtype.

Train mode runs ``aten.native_batch_norm`` without running statistics: one
normalising kernel (the channels-last CUDA kernels on the card) that returns
the batch mean and ``invstd``, from which the float32 buffers are updated
with ``var = invstd^-2 - eps``. It has no ``num_batches_tracked``; the weight
bridge carries ``running_mean``/``running_var`` as flax's
``batch_stats/{mean,var}``.

Global-batch statistics (the JAX package's ``bn_cross_replica_axis`` and
its multi-device train step, whose BatchNorm sees the whole sharded batch,
``hawkeye_tpu/parallel/mesh.py:10-13``): with ``cross_replica`` on and a
``torch.distributed`` world of more than one process, train mode is
``_GlobalBatchNorm``, built on the four passes of ``ops/batch_norm.py``
(hand-written kernels on the card): each rank's per-channel sum, sum of
squares and count, all-reduced in place; the normalisation with the global
mean and the biased variance ``E[x^2] - E[x]^2`` (flax's fast variance, as
its ``pmean`` of ``[mean, mean of squares]`` gives), folded into the
running statistics with flax's momentum; backward, each rank's sums of
``dy`` and ``dy * xhat``, all-reduced in place, then ``dx``. The input is a
channels-last map or a 2-D ``[M, C]`` tensor (anything else raises); it
saves ``x`` and no float32 copy of it. Not ``nn.SyncBatchNorm``: that folds
the unbiased variance with torch's momentum. In a world of one process, or
with it off, it is the plain path, ``aten.native_batch_norm``.
``set_cross_replica(module, on)`` switches every norm layer of a model (the
Trainer does so when it runs in more than one process).

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

from ...ops import batch_norm as bn
from ...parallel.mesh import all_reduce_sum, world
from ...utils import trace


class _GlobalBatchNorm(torch.autograd.Function):
    """Train-mode normalisation of ``x`` with the statistics of the batches
    of every process: ``(y, mean, biased var)``, the statistics not
    differentiable. Two passes and one in-place all-reduce each way (the
    span ``allreduce.bn_stats`` around each all-reduce); ``dweight`` and
    ``dbias`` are the rank's own sums, which the gradient average averages
    over the ranks afterwards."""

    @staticmethod
    def forward(ctx, x, weight, bias, eps):
        stats = bn.batch_norm_stats(x)
        with trace.span("allreduce.bn_stats"):
            all_reduce_sum(stats)
        y, mean, var, invstd = bn.batch_norm_apply(x, stats, weight, bias, eps)
        ctx.save_for_backward(x, weight, mean, invstd, stats[-1:])
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _mean, _var):
        x, weight, mean, invstd, count = ctx.saved_tensors
        # dy in x's layout: the trunks' gradients arrive so, and this copies
        # nothing there (tests/test_torch_batch_norm_xr.py); CrossX's part
        # norms, read through a spatial mean, get theirs in NCHW
        dy = dy.contiguous(memory_format=torch.channels_last if dy.dim() == 4
                           else torch.contiguous_format)
        sums, dweight, dbias = bn.batch_norm_backward_reduce(dy, x, mean, invstd)
        with trace.span("allreduce.bn_stats"):
            all_reduce_sum(sums)
        dx = bn.batch_norm_backward_apply(dy, x, mean, invstd, weight, sums, count)
        return dx, dweight, dbias, None


def batch_norm_train(x, weight, bias, eps, cross_replica=False):
    """Train-mode normalisation of NCHW ``x`` with its batch's statistics
    (the global batch's with ``cross_replica`` in a world of more than one
    process): (y in ``x``'s dtype, batch mean, biased variance), the
    statistics detached and at least float32. The span ``batch_norm`` covers
    it, and ``batch_norm.backward`` its backward (``utils/trace.py``)."""
    with trace.span("batch_norm", backward=True):
        if cross_replica and world()[1] > 1:
            y, mean, var = _GlobalBatchNorm.apply(x, weight, bias, eps)
        else:
            y, mean, invstd = torch.ops.aten.native_batch_norm(
                x, weight, bias, None, None, True, 0.0, eps)
            var = invstd.detach().pow(-2).sub_(eps)
    return y, mean, var


class BatchNorm(nn.Module):
    def __init__(self, num_features, momentum=0.9, eps=1e-5, cross_replica=False):
        super().__init__()
        self.cross_replica = bool(cross_replica)
        self.momentum = float(momentum)
        self._rate = self.fold_rate(momentum)
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
        y, mean, var = batch_norm_train(x, self.weight, self.bias, self.eps,
                                        self.cross_replica)
        self.fold(mean, var)
        return y

    @staticmethod
    def fold_rate(momentum):
        """``1 - momentum`` as flax.linen's BatchNorm folds it."""
        return 1.0 - float(momentum)

    @torch.no_grad()
    def fold(self, mean, var):
        """flax's running-average update with a batch's mean and biased
        variance."""
        self.running_mean.mul_(self.momentum).add_(mean, alpha=self._rate)
        self.running_var.mul_(self.momentum).add_(var, alpha=self._rate)


def set_cross_replica(module, on=True):
    """Global-batch statistics on (or off) in every norm layer of
    ``module``."""
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.cross_replica = bool(on)
    return module


class GroupedBatchNorm(BatchNorm):
    """``BatchNorm`` whose train-mode statistics are per batch group.

    ``groups`` (set by the caller before a forward, as the ResNet's
    ``bn_groups`` does) is an int G, G equal contiguous groups, or a tuple
    of the groups' sizes, such as ``(B, B*M)``; 1 is plain ``BatchNorm``.
    Eval mode ignores it."""

    def __init__(self, num_features, momentum=0.9, eps=1e-5, cross_replica=False):
        super().__init__(num_features, momentum, eps, cross_replica)
        self.groups = 1

    @staticmethod
    def fold_rate(momentum):
        """``1 - momentum`` in float32, as the JAX GroupedBatchNorm folds it."""
        return float(np.float32(1.0) - np.float32(momentum))

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
