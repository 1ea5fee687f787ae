"""Peak finding: local maxima above the map's mean.

Counterpart of ``hawkeye_tpu/ops/peaks.py`` (reference
``model/methods/S3N.py:57-98``, a custom autograd Function that returns a
peak list and routes the aggregation's gradient uniformly onto the peaks).
The peaks stay a fixed-shape mask; the aggregation is the mean of ``x`` over
the mask, with the mask detached, so that autograd gives the reference's
routing. Plain tensor ops: no host round trip.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def peak_mask(x, win_size: int = 3, use_mean_filter: bool = True):
    """``x``: [..., H, W] response maps -> bool mask of their local maxima.

    A position is a peak where it is >= the max of its ``win_size`` square
    window (``max_pool2d`` pads with ``-inf``, so the window is clipped at
    the border) and, with the mean filter, >= the mean of its map."""
    if win_size % 2 != 1:
        raise ValueError(f"win_size must be odd, got {win_size}")
    h, w = x.shape[-2:]
    flat = x.reshape(-1, 1, h, w)
    pooled = F.max_pool2d(flat, win_size, 1, (win_size - 1) // 2)
    mask = (flat >= pooled).reshape(x.shape)
    if use_mean_filter:
        mask = mask & (x >= x.mean(dim=(-2, -1), keepdim=True))
    return mask


def peak_stimulation(x, win_size: int = 3, use_mean_filter: bool = True):
    """(mask [..., H, W] bool, aggregation [...]: the mean of ``x`` over its
    peaks)."""
    with torch.no_grad():
        mask = peak_mask(x, win_size, use_mean_filter)
    m = mask.to(x.dtype)
    agg = (x * m).sum(dim=(-2, -1)) / m.sum(dim=(-2, -1)).clamp_min(1e-6)
    return mask, agg
