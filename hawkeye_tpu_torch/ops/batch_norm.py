"""Train-mode BatchNorm over the global batch: the four passes of the
cross-replica path (``models/backbones/norm.py``), each a hand-written
kernel on the card.

Each takes ``x`` (and ``dy``) as a 2-D ``[M, C]`` tensor or a 4-D NCHW map
in channels-last memory, and works on the rows view ``[M, C]`` (M = N*H*W),
with the statistics in float32 (in float64 for a float64 ``x``, which only
the plain versions take):

* ``batch_norm_stats(x)``: ``[2C+1]`` = (sum x, sum x^2, the count M), the
  buffer that ``all_reduce_sum`` then sums over the ranks in place;
* ``batch_norm_apply(x, stats, weight, bias, eps)``: ``(y, mean, var,
  invstd)`` from the reduced statistics, with the biased variance
  ``max(E[x^2] - E[x]^2, 0)`` (flax's fast variance), y in x's dtype and
  layout;
* ``batch_norm_backward_reduce(dy, x, mean, invstd)``: ``(sums [2C] =
  (sum dy, sum dy * xhat), dweight, dbias)``, the rank's own sums twice:
  once to be all-reduced in place and once as the local parameter
  gradients, which the gradient average then averages;
* ``batch_norm_backward_apply(dy, x, mean, invstd, weight, sums, count)``:
  ``dx = w * invstd * (dy - G0/n - xhat * G1/n)`` with ``G`` the reduced
  sums and ``n`` the global count (``count``, a 1-element tensor: the last
  slot of the reduced statistics).

On a CUDA tensor each launches its kernel in ``csrc/batch_norm.cu`` (bf16
and float32 only; a 4-D tensor must be channels-last contiguous, a 2-D one
contiguous; anything else raises). On a CPU tensor each runs its plain
version beside it (``*_plain``), in the same order of operations, which the
CPU tests and the gloo processes use.
"""

from __future__ import annotations

import torch

from . import _build

# scratch for the reductions' per-block partial sums: the kernels use at
# most 2 x 264 blocks' worth of min(C, 512) channels (see csrc/batch_norm.cu)
_PARTIAL_ROWS = 528
_counters: dict = {}  # (device, stream) -> the reductions' per-tile counters


def rows(t):
    """The ``[M, C]`` rows view of a contiguous 2-D tensor or of a 4-D NCHW
    map in channels-last memory; raises for any other layout."""
    if t.dim() == 2 and t.is_contiguous():
        return t
    if t.dim() == 4 and t.is_contiguous(memory_format=torch.channels_last):
        return t.permute(0, 2, 3, 1).view(-1, t.shape[1])
    raise ValueError("batch norm kernels take a contiguous [M, C] tensor or a "
                     f"channels-last NCHW map, got shape {tuple(t.shape)} with "
                     f"strides {t.stride()}")


def _shaped(r, like):
    """Rows ``r`` back in the shape (and channels-last layout) of ``like``."""
    if like.dim() == 2:
        return r
    n, c, h, w = like.shape
    return r.view(n, h, w, c).permute(0, 3, 1, 2)


# ----------------------------------------------------------------------------
# plain versions, on rows
# ----------------------------------------------------------------------------
def batch_norm_stats_plain(x):
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    count = torch.full((1,), x.shape[0], dtype=xf.dtype, device=x.device)
    return torch.cat([xf.sum(0), (xf * xf).sum(0), count])


def batch_norm_apply_plain(x, stats, weight, bias, eps):
    c = x.shape[1]
    n = stats[2 * c]
    mean = stats[:c] / n
    var = torch.clamp_min(stats[c:2 * c] / n - mean * mean, 0.0)
    invstd = 1.0 / torch.sqrt(var + eps)
    y = ((x.to(mean.dtype) - mean) * (invstd * weight) + bias).to(x.dtype)
    return y, mean, var, invstd


def batch_norm_backward_reduce_plain(dy, x, mean, invstd):
    dyf = dy.to(mean.dtype)
    sum_dy = dyf.sum(0)
    sum_dy_xhat = (dyf * (x.to(mean.dtype) - mean)).sum(0) * invstd
    return torch.cat([sum_dy, sum_dy_xhat]), sum_dy_xhat, sum_dy


def batch_norm_backward_apply_plain(dy, x, mean, invstd, weight, sums, count):
    c = x.shape[1]
    n = count[0]
    k1 = sums[:c] / n
    k2 = invstd * (sums[c:] / n)
    dx = (weight * invstd) * (dy.to(mean.dtype) - k1 - (x.to(mean.dtype) - mean) * k2)
    return dx.to(x.dtype)


# ----------------------------------------------------------------------------
# kernel wrappers: plain version on a CPU tensor, the CUDA kernel otherwise
# ----------------------------------------------------------------------------
def _scratch(c, device):
    """The partial sums' scratch and the per-tile counters of a reduction on
    ``device``'s current stream. The counters are zeroed once and left at 0
    by every launch (the last block of a tile resets its own), so launches
    on one stream share them."""
    stream = torch.cuda.current_stream(device).cuda_stream
    key = (device, stream)
    need = (c + 63) // 64
    arrived = _counters.get(key)
    if arrived is None or arrived.numel() < need:
        arrived = _counters[key] = torch.zeros(need, dtype=torch.int32, device=device)
    partial = torch.empty(_PARTIAL_ROWS * min(c, 512), dtype=torch.float32, device=device)
    return partial, arrived


def _check(name, *tensors, floats=()):
    _build.require_cuda(name, *tensors, *floats)
    for t in floats:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: statistics and parameters must be float32, "
                            f"got {t.dtype}")
    return _build.dtype_code(tensors[0].dtype)


def batch_norm_stats(x):
    """(sum x, sum x^2, count) per channel of ``x``'s rows; the
    ``batch_norm_stats`` kernel."""
    r = rows(x)
    if x.device.type == "cpu":
        return batch_norm_stats_plain(r)
    code = _check("batch_norm_stats", r)
    m, c = r.shape
    stats = torch.empty(2 * c + 1, dtype=torch.float32, device=x.device)
    partial, arrived = _scratch(c, x.device)
    rc = _build.kernel("hk_batch_norm_stats")(
        code, r.data_ptr(), m, c, stats.data_ptr(), partial.data_ptr(),
        partial.numel(), arrived.data_ptr(), arrived.numel(), _build.stream_of(x))
    _build.check(rc, "batch_norm_stats")
    _build.LAUNCHES["batch_norm_stats"] += 1
    return stats


def batch_norm_apply(x, stats, weight, bias, eps):
    """(y, mean, var, invstd) from the reduced ``stats``; the
    ``batch_norm_apply`` kernel."""
    r = rows(x)
    if x.device.type == "cpu":
        y, mean, var, invstd = batch_norm_apply_plain(r, stats, weight, bias, eps)
        return _shaped(y, x), mean, var, invstd
    code = _check("batch_norm_apply", r, floats=(stats, weight, bias))
    m, c = r.shape
    y = torch.empty_like(r)
    mean, var, invstd = (torch.empty(c, dtype=torch.float32, device=x.device)
                         for _ in range(3))
    rc = _build.kernel("hk_batch_norm_apply")(
        code, r.data_ptr(), stats.data_ptr(), weight.data_ptr(), bias.data_ptr(),
        float(eps), y.data_ptr(), mean.data_ptr(), var.data_ptr(),
        invstd.data_ptr(), m, c, _build.stream_of(x))
    _build.check(rc, "batch_norm_apply")
    _build.LAUNCHES["batch_norm_apply"] += 1
    return _shaped(y, x), mean, var, invstd


def batch_norm_backward_reduce(dy, x, mean, invstd):
    """(sums [2C], dweight, dbias) of the rank's rows; the
    ``batch_norm_backward_reduce`` kernel."""
    rdy, rx = rows(dy), rows(x)
    if rdy.shape != rx.shape:
        raise ValueError(f"batch_norm_backward_reduce: dy {tuple(dy.shape)} and "
                         f"x {tuple(x.shape)} differ")
    if x.device.type == "cpu":
        return batch_norm_backward_reduce_plain(rdy, rx, mean, invstd)
    code = _check("batch_norm_backward_reduce", rdy, rx, floats=(mean, invstd))
    if dy.dtype != x.dtype:
        raise TypeError(f"batch_norm_backward_reduce: dy {dy.dtype}, x {x.dtype}")
    m, c = rx.shape
    sums = torch.empty(2 * c, dtype=torch.float32, device=x.device)
    dweight, dbias = (torch.empty(c, dtype=torch.float32, device=x.device) for _ in range(2))
    partial, arrived = _scratch(c, x.device)
    rc = _build.kernel("hk_batch_norm_backward_reduce")(
        code, rdy.data_ptr(), rx.data_ptr(), mean.data_ptr(), invstd.data_ptr(),
        m, c, sums.data_ptr(), dweight.data_ptr(), dbias.data_ptr(),
        partial.data_ptr(), partial.numel(), arrived.data_ptr(), arrived.numel(),
        _build.stream_of(x))
    _build.check(rc, "batch_norm_backward_reduce")
    _build.LAUNCHES["batch_norm_backward_reduce"] += 1
    return sums, dweight, dbias


def batch_norm_backward_apply(dy, x, mean, invstd, weight, sums, count):
    """dx from the reduced ``sums`` and global ``count``; the
    ``batch_norm_backward_apply`` kernel."""
    rdy, rx = rows(dy), rows(x)
    if rdy.shape != rx.shape:
        raise ValueError(f"batch_norm_backward_apply: dy {tuple(dy.shape)} and "
                         f"x {tuple(x.shape)} differ")
    if x.device.type == "cpu":
        return _shaped(batch_norm_backward_apply_plain(
            rdy, rx, mean, invstd, weight, sums, count), x)
    code = _check("batch_norm_backward_apply", rdy, rx,
                  floats=(mean, invstd, weight, sums, count))
    if dy.dtype != x.dtype:
        raise TypeError(f"batch_norm_backward_apply: dy {dy.dtype}, x {x.dtype}")
    m, c = rx.shape
    dx = torch.empty_like(rx)
    rc = _build.kernel("hk_batch_norm_backward_apply")(
        code, rdy.data_ptr(), rx.data_ptr(), mean.data_ptr(), invstd.data_ptr(),
        weight.data_ptr(), sums.data_ptr(), count.data_ptr(), dx.data_ptr(), m, c,
        _build.stream_of(x))
    _build.check(rc, "batch_norm_backward_apply")
    _build.LAUNCHES["batch_norm_backward_apply"] += 1
    return _shaped(dx, x)
