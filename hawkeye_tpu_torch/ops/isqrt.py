"""Covariance pooling with an iterative matrix square root (Fast MPN-COV),
plain PyTorch.

Counterpart of ``hawkeye_tpu/ops/isqrt.py`` (reference
``model/methods/MPNCOV.py:105-230``):

* ``covariance_pool``: ``X I_bar X^T``, the centred covariance over the
  ``M = H*W`` positions, ``[B, C, C]`` per batch;
* ``newton_schulz_sqrt``: the coupled Newton-Schulz iteration, normalised
  by the trace (clamped at 1e-8) and scaled back by its square root;
* ``triu_vec``: the upper triangle, row-major (``torch.triu_indices`` gives
  ``jnp.triu_indices``'s order).

All in float32, whatever the input dtype, as in the JAX package. The
gradient is autograd's through the loop of batched matmuls, as JAX
differentiates through its ``fori_loop``; there is no hand-written backward.
"""

from __future__ import annotations

import torch


def covariance_pool(features):
    """[B, H, W, C] -> [B, C, C] covariance, float32."""
    b, h, w, c = features.shape
    m = h * w
    x = features.reshape(b, m, c).float()
    xc = x - x.mean(dim=1, keepdim=True)
    return torch.bmm(xc.transpose(1, 2), xc) / float(m)


def newton_schulz_sqrt(mats, num_iters: int = 5, coupled_batched: bool = True):
    """Batched matrix square root of SPD ``mats`` [B, C, C] by coupled
    Newton-Schulz. ``coupled_batched`` computes each iteration's two
    products, ``Y T`` and ``T Z``, as one ``[2B, C, C]`` bmm (the default);
    off, as two ``[B, C, C]`` bmms. The two give the same values."""
    mats = mats.float()
    b, c, _ = mats.shape
    ident = torch.eye(c, dtype=torch.float32, device=mats.device)
    tr = mats.diagonal(dim1=1, dim2=2).sum(-1)[:, None, None]  # [B, 1, 1]
    tr = torch.clamp_min(tr, 1e-8)
    y = mats / tr
    z = ident.expand(b, c, c)
    for _ in range(num_iters):
        t = 0.5 * (3.0 * ident - torch.bmm(z, y))
        if coupled_batched:
            out = torch.bmm(torch.cat([y, t]), torch.cat([t, z]))
            y, z = out[:b], out[b:]
        else:
            y, z = torch.bmm(y, t), torch.bmm(t, z)
    return y * torch.sqrt(tr)


def triu_vec(mats):
    """[B, C, C] -> [B, C(C+1)/2], the upper triangle, row-major."""
    c = mats.shape[-1]
    iu = torch.triu_indices(c, c, device=mats.device)
    return mats[:, iu[0], iu[1]]


def mpn_cov_pool(features, num_iters: int = 5):
    """Covariance, then the iterative square root, then the triangle."""
    return triu_vec(newton_schulz_sqrt(covariance_pool(features), num_iters))
