"""Device-resident batched augmentation (the device pipeline).

Counterpart of ``hawkeye_tpu/data/transforms_device.py``: the host only
decodes and fixes the shape (uint8 [B, R, R, 3]); random-resized crop,
horizontal flip, TrivialAugmentWide, normalisation and random erasing run
on the device over the whole batch, the crop and resize as batched matrix
products (``ops/resample.crop_resize_bilinear``).

Randomness comes from an explicit ``torch.Generator`` on the device (the
stream differs from JAX's by design). Each sampler is split into the draws
(``sample_*``) and a pure function of them, so the tests can feed the JAX
package's draws: ``make_train_augment(...)(generator, batch)`` is
``apply_train_augment(batch, sample_train_draws(generator, ...), ...)``.

Known deltas against torchvision, as in the JAX package: crop boxes are
clamped instead of rejection-sampled, and downscaling is plain bilinear
without PIL's antialias.
"""

from __future__ import annotations

import math

import torch

from ..ops.resample import crop_resize_bilinear
from ..utils.tensors import device_constant
from .ta_wide_device import sample_ta_wide, ta_wide_apply

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _uniform(generator, b, lo=0.0, hi=1.0):
    u = torch.rand((b,), generator=generator, device=generator.device)
    return u * (hi - lo) + lo


def rrc_boxes(area_frac, log_ratio, u_y, u_x, h, w):
    """RandomResizedCrop boxes [B, 4] = (y0, x0, ch, cw) in pixels, from the
    draws: area fraction in ``scale``, log aspect ratio in ``log(ratio)``,
    and two uniforms in [0, 1) that place the box."""
    target = float(h * w) * area_frac
    aspect = torch.exp(log_ratio)
    cw = torch.sqrt(target * aspect).clamp(8.0, float(w))
    ch = torch.sqrt(target / aspect).clamp(8.0, float(h))
    return torch.stack([u_y * (h - ch), u_x * (w - cw), ch, cw], dim=1)


def sample_rrc_boxes(generator, b, h, w, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)):
    return rrc_boxes(_uniform(generator, b, *scale),
                     _uniform(generator, b, math.log(ratio[0]), math.log(ratio[1])),
                     _uniform(generator, b), _uniform(generator, b), h, w)


def hflip(images, mask):
    """Flip the images whose ``mask`` entry is true (NHWC)."""
    return torch.where(mask[:, None, None, None], images.flip(2), images)


def normalize(images, mean=IMAGENET_MEAN, std=IMAGENET_STD):
    m = device_constant(tuple(mean), torch.float32, images.device)
    s = device_constant(tuple(std), torch.float32, images.device)
    return (images - m) / s


def random_erase(images, on, area_frac, log_ratio, u_y, u_x, value=0.0):
    """Batched RandomErasing from the draws: one candidate rectangle per
    image (always in bounds by construction), erased where ``on``."""
    b, h, w, _ = images.shape
    target = float(h * w) * area_frac
    eh = torch.sqrt(target * torch.exp(log_ratio)).clamp(1.0, float(h - 1))
    ew = torch.sqrt(target / torch.exp(log_ratio)).clamp(1.0, float(w - 1))
    y0 = u_y * (h - eh)
    x0 = u_x * (w - ew)
    ys = torch.arange(h, dtype=torch.float32, device=images.device)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=images.device)[None, None, :]
    inside = ((ys >= y0[:, None, None]) & (ys < (y0 + eh)[:, None, None])
              & (xs >= x0[:, None, None]) & (xs < (x0 + ew)[:, None, None]))
    erase = inside & on[:, None, None]
    return torch.where(erase[..., None], value, images)


def sample_erase(generator, b, prob, scale=(0.02, 0.33), ratio=(0.3, 3.3)):
    """Draws for ``random_erase``: (on, area_frac, log_ratio, u_y, u_x)."""
    on = _uniform(generator, b) < prob
    return (on, _uniform(generator, b, *scale),
            _uniform(generator, b, math.log(ratio[0]), math.log(ratio[1])),
            _uniform(generator, b), _uniform(generator, b))


def sample_train_draws(generator, b, h, w, hflip_prob=0.5, erase_prob=0.1,
                       scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                       auto_augment=None):
    """Every random draw of one train augmentation of a [b, h, w] batch."""
    draws = {"boxes": sample_rrc_boxes(generator, b, h, w, scale, ratio)}
    if hflip_prob > 0:
        draws["flip"] = _uniform(generator, b) < hflip_prob
    if auto_augment == "ta_wide":
        draws["ta_op"], draws["ta_mag"] = sample_ta_wide(generator, b)
    if erase_prob > 0:
        draws["erase"] = sample_erase(generator, b, erase_prob)
    return draws


def apply_train_augment(batch_u8, draws, image_size, mean=IMAGENET_MEAN,
                        std=IMAGENET_STD, out_dtype=torch.float32,
                        compute_dtype=torch.bfloat16):
    """RandomResizedCrop with the flip folded in -> TA-wide -> normalize ->
    erase, on uint8 [B, R, R, 3]; returns [B, S, S, 3] in ``out_dtype``."""
    imgs = batch_u8.to(compute_dtype) / 255.0
    out = crop_resize_bilinear(imgs, draws["boxes"], image_size, image_size,
                               dtype=compute_dtype, flip_x_mask=draws.get("flip"))
    if "ta_op" in draws:
        out = ta_wide_apply(out.float(), draws["ta_op"], draws["ta_mag"])
    out = normalize(out.float(), mean, std)
    if "erase" in draws:
        out = random_erase(out, *draws["erase"])
    return out.to(out_dtype)


def make_train_augment(image_size: int, hflip_prob=0.5, erase_prob=0.1,
                       scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3),
                       mean=IMAGENET_MEAN, std=IMAGENET_STD, auto_augment=None,
                       out_dtype=torch.float32, compute_dtype=torch.bfloat16):
    """Build ``augment(generator, uint8 [B, R, R, 3]) -> [B, S, S, 3]``.

    Order matches the host preset (``transforms_host.TrainPreset``):
    RandomResizedCrop -> HFlip -> auto-augment policy -> normalize -> erase.
    The crop-resize products run in ``compute_dtype`` (bfloat16 by default);
    ``auto_augment='ta_wide'`` enables the batched TrivialAugmentWide.
    """

    def augment(generator, batch_u8):
        b, h, w, _ = batch_u8.shape
        draws = sample_train_draws(generator, b, h, w, hflip_prob, erase_prob,
                                   scale, ratio, auto_augment)
        return apply_train_augment(batch_u8, draws, image_size, mean, std,
                                   out_dtype, compute_dtype)

    return augment


def make_eval_transform(image_size: int, mean=IMAGENET_MEAN, std=IMAGENET_STD,
                        out_dtype=torch.float32):
    """Build the eval prep: center crop-resize (torchvision's image_size out
    of the square ``resize_size`` the host decoded) + normalize."""

    def prep(batch_u8):
        b, h, w, _ = batch_u8.shape
        imgs = batch_u8.float() / 255.0
        if (h, w) != (image_size, image_size):
            box = device_constant(((h - image_size) / 2.0, (w - image_size) / 2.0,
                                   float(image_size), float(image_size)),
                                  torch.float32, imgs.device)
            imgs = crop_resize_bilinear(imgs, box.expand(b, 4), image_size,
                                        image_size)
        return normalize(imgs, mean, std).to(out_dtype)

    return prep
