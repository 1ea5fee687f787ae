"""Batch-level Mixup / CutMix on the device.

Counterpart of ``hawkeye_tpu/data/mixup.py`` (reference
``dataset/transforms.py:76-240``, RandomMixup / RandomCutmix through
``MixupCutmixCollateFn``, ``dataset/collate_fn.py:8-17``): defined in the
reference but used by no Example, kept as API surface. One batch op with
torchvision v0.13's semantics: with probability ``p`` the batch is mixed,
by Mixup or CutMix at even odds, with the batch rolled by one; it returns
soft labels ``[B, C]``, which the port's cross-entropy takes.

The draws: an ``apply`` and a ``cutmix`` coin, ``lam`` from
Beta(alpha, alpha) (``mixup_alpha`` or ``cutmix_alpha``, by the branch) and
CutMix's box centre as two uniform fractions ``cy``, ``cx`` of the image's
side. They come from ``generator`` (a ``torch.Generator`` on the images'
device) or, all of them, from ``draws``, so that a caller can feed the JAX
package's (``jax.random.split`` of its key). Both branches are computed and
selected on the device, so nothing waits on the host. The box edges and the
area it cuts are computed in float32, as the JAX function computes them,
so the two packages' masks agree at the same draws; the blends round as
XLA's fused multiply-add does, so the mixed pixels agree to the bit on the
CPU.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _gamma(alpha, generator, device, tries=16):
    """One Gamma(alpha, 1) draw on the device, by Marsaglia and Tsang's
    method over ``tries`` candidates (each accepted with probability above
    0.95 for a shape of 1 or more; a shape below 1 is boosted by a uniform
    to the power 1/alpha)."""
    a = alpha if alpha >= 1.0 else alpha + 1.0
    d = a - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    z = torch.randn(tries, generator=generator, device=device)
    u = torch.rand(tries, generator=generator, device=device)
    v = (1.0 + c * z) ** 3
    ok = (v > 0) & (torch.log(u) < 0.5 * z * z + d - d * v + d * torch.log(v.clamp_min(1e-30)))
    g = (d * v)[ok.to(torch.uint8).argmax()]
    if alpha < 1.0:
        g = g * torch.rand((), generator=generator, device=device) ** (1.0 / alpha)
    return g


def _beta(alpha, generator, device):
    a = _gamma(alpha, generator, device)
    return a / (a + _gamma(alpha, generator, device))


def draw(generator, mixup_alpha=0.2, cutmix_alpha=1.0, p=0.5):
    """The draws of one batch from ``generator``, as device scalars."""
    dev = generator.device
    use_cutmix = torch.rand((), generator=generator, device=dev) < 0.5
    return {
        "apply": torch.rand((), generator=generator, device=dev) < p,
        "cutmix": use_cutmix,
        "lam": torch.where(use_cutmix, _beta(cutmix_alpha, generator, dev),
                           _beta(mixup_alpha, generator, dev)),
        "cy": torch.rand((), generator=generator, device=dev),
        "cx": torch.rand((), generator=generator, device=dev),
    }


def mixup_cutmix(images, labels, num_classes, mixup_alpha=0.2, cutmix_alpha=1.0,
                 p=0.5, generator=None, draws=None):
    """Mixup or CutMix of ``images`` [B, H, W, C] with probability ``p``.

    Returns (images, soft labels [B, num_classes] float32). ``draws``
    (``apply``, ``cutmix``, ``lam``, ``cy``, ``cx``; booleans and floats or
    device scalars) replaces the draws from ``generator``."""
    if draws is None:
        if generator is None:
            raise ValueError("mixup_cutmix draws from a generator: pass "
                             "generator= or draws=")
        draws = draw(generator, mixup_alpha, cutmix_alpha, p)
    dev = images.device
    f32 = torch.float32

    def scalar(v, dtype):
        return torch.as_tensor(v, dtype=dtype, device=dev)

    apply, cutmix = scalar(draws["apply"], torch.bool), scalar(draws["cutmix"], torch.bool)
    lam = scalar(draws["lam"], f32)
    one_hot = F.one_hot(labels.long(), num_classes).to(f32)
    rolled_img = torch.roll(images, 1, dims=0)
    rolled_lab = torch.roll(one_hot, 1, dims=0)

    # Mixup, as XLA computes ``x * lam + r * (1 - lam)``: one fused
    # multiply-add of x * lam onto the rounded r * (1 - lam)
    mix_img = torch.addcmul(rolled_img * (1 - lam), images, lam)
    mix_lab = torch.addcmul(rolled_lab * (1 - lam), one_hot, lam)

    # CutMix: the box and its area in float32
    _, h, w, _ = images.shape
    rh = torch.sqrt(1.0 - lam) * h
    rw = torch.sqrt(1.0 - lam) * w
    cy = scalar(draws["cy"], f32) * h
    cx = scalar(draws["cx"], f32) * w
    y0, y1 = torch.clamp(cy - rh / 2, 0, h), torch.clamp(cy + rh / 2, 0, h)
    x0, x1 = torch.clamp(cx - rw / 2, 0, w), torch.clamp(cx + rw / 2, 0, w)
    ys = torch.arange(h, dtype=f32, device=dev)[:, None]
    xs = torch.arange(w, dtype=f32, device=dev)[None, :]
    inside = (ys >= y0) & (ys < y1) & (xs >= x0) & (xs < x1)
    cut_img = torch.where(inside[None, :, :, None], rolled_img, images)
    lam_adj = 1.0 - (y1 - y0) * (x1 - x0) / (h * w)
    cut_lab = torch.addcmul(rolled_lab * (1 - lam_adj), one_hot, lam_adj)

    img = torch.where(apply, torch.where(cutmix, cut_img, mix_img), images)
    lab = torch.where(apply, torch.where(cutmix, cut_lab, mix_lab), one_hot)
    return img, lab
