"""Bilinear (second-order) pooling, plain PyTorch.

Counterpart of ``hawkeye_tpu/ops/bilinear.py``. Reference semantics
(``model/methods/BCNN.py:13-27``): for conv features X in [HW, C] per image,
``(X^T X) / HW`` -> flatten C^2 -> signed sqrt ``sign(x)*sqrt(|x|+eps)`` ->
global L2 normalisation. The fused version with a CUDA kernel is in
``ops/fused_bilinear.py``.
"""

from __future__ import annotations

import torch


def ssqrt(v, eps=1e-5):
    """Signed square root ``sign(v) * sqrt(|v| + eps)``."""
    return torch.sign(v) * torch.sqrt(torch.abs(v) + eps)


def l2_rows(v):
    """Divide each row by its L2 norm (floored at 1e-12)."""
    return v / torch.clamp_min(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                               1e-12)


def gram(x):
    """[B, HW, C] -> [B, C, C] = X^T X / HW, accumulated in float32 (float64
    for float64 features: a float64 model is its own reference)."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    return torch.bmm(xf.transpose(1, 2), xf) / float(x.shape[1])


def bilinear_pool(features, *, signed_sqrt=True, l2_normalize=True,
                  eps=1e-5):
    """[B, H, W, C] -> [B, C*C] bilinear-pooled descriptor, float32 (float64
    for float64 features)."""
    b, h, w, c = features.shape
    v = gram(features.reshape(b, h * w, c)).reshape(b, c * c)
    if signed_sqrt:
        v = ssqrt(v, eps)
    if l2_normalize:
        v = l2_rows(v)
    return v
