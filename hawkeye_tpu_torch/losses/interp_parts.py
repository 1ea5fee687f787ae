"""Interp-Parts loss: CE + the shaping loss against a Beta prior.

Counterpart of ``hawkeye_tpu/losses/interp_parts.py`` (reference
``model/loss/InterpParts_loss.py``): the assignment maps [B, H, W, K] are
blurred by a depthwise Gaussian (radius 2, std 0.4; VALID where
``min(H, W) > 2 * radius``, else SAME), max-pooled over H and W to each
part's occurrence [B, K], sorted ascending over the batch, and held in log
space against the Beta(alpha, beta) inverse CDF at the batch midpoints:
``mean |log(emp + eps) - log(prior + eps)|``. CE has NO label smoothing
(the reference's ``InterpParts_loss.py:22``).

The prior comes from ``scipy.stats.beta.ppf`` in numpy on the host, once
per batch size and device, and stays on the device: a train step makes no
host-to-device copy for it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..registry import LOSS
from ..utils.tensors import device_constant
from . import at_least_f32, cross_entropy


def gaussian_kernel(radius, std):
    ii = np.arange(-radius, radius + 1)
    d2 = ii[:, None] ** 2 + ii[None, :] ** 2
    w = np.exp(-d2 / (2 * std * std)).astype(np.float32)
    return w / w.sum()


def beta_prior(b, alpha, beta):
    """The Beta(alpha, beta) inverse CDF at the midpoints of ``b`` equal
    bins, float32 [b, 1]."""
    from scipy import stats

    grid = np.arange(1, 2 * b, 2, dtype=np.float64) / (2 * b)
    return stats.beta.ppf(grid, a=alpha, b=beta).astype(np.float32)[:, None]


def shaping_loss(assign, radius, std, prior, eps=1e-5):
    """assign: [B, H, W, K]; ``prior``: [B, 1] on the same device."""
    b, h, w, k = assign.shape
    x = at_least_f32(assign).permute(0, 3, 1, 2)  # NCHW, one channel a part
    if radius > 0:
        kern = device_constant(tuple(gaussian_kernel(radius, std).ravel().tolist()),
                               x.dtype, x.device)
        size = 2 * radius + 1
        pad = 0 if min(h, w) > 2 * radius else radius  # VALID, else SAME
        x = F.conv2d(x, kern.view(1, 1, size, size).expand(k, 1, size, size),
                     padding=pad, groups=k)
    part_occ = x.amax(dim=(2, 3))  # [B, K]
    emp = torch.sort(part_occ, dim=0).values  # ascending over the batch
    prior = prior.to(x.dtype)
    return torch.abs(torch.log(emp + eps) - torch.log(prior + eps)).mean()


class InterpPartsLoss:
    def __init__(self, config=None):
        cfg = config or {}
        get = cfg.get if hasattr(cfg, "get") else lambda k, d=None: d
        self.radius = int(get("radius", 2))
        self.std = float(get("std", 0.4))
        self.alpha = float(get("alpha", 1.0))
        self.beta = float(get("beta", 0.001))
        self.coeff = float(get("coeff", 0.5))
        self._priors = {}

    def prior(self, b, device):
        key = (b, str(device))
        if key not in self._priors:
            self._priors[key] = torch.from_numpy(
                beta_prior(b, self.alpha, self.beta)).to(device)
        return self._priors[key]

    def __call__(self, outputs, batch):
        loss_ce = cross_entropy(outputs["logits"], batch["label"], 0.0,
                                weights=batch.get("weight"))
        assign = outputs["assign"]
        shape = shaping_loss(assign, self.radius, self.std,
                             self.prior(assign.shape[0], assign.device))
        return loss_ce + self.coeff * shape


LOSS.register(InterpPartsLoss, name="InterpPartsLoss")
