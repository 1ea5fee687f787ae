"""Device-side TrivialAugmentWide: one random op per image, fully batched.

Counterpart of ``hawkeye_tpu/data/ta_wide_device.py``. Split in two so the
tests can feed the JAX package's draws: ``sample_ta_wide(generator, b)``
draws each image's op and signed magnitude from an explicit
``torch.Generator`` (the stream differs from JAX's by design), and
``ta_wide_apply(images, op, mag)`` applies them:

- the geometric ops (shear/translate/rotate, with identity) are one
  per-image affine grid sample (PIL AFFINE semantics: output -> input map,
  zero fill);
- the photometric ops are elementwise passes selected per image;
- Equalize maps each pixel through a 64-knot CDF of its image's channel
  (the JAX package's approximation of PIL's 256-bin remap).

Every op is computed for the whole batch and selected per image, so the
program has no host synchronisation. The CDF is a histogram of each pixel's
first knot at or above it, cumulated, which equals the JAX package's count
of pixels at or below each knot without its [K, B, H, W, C] broadcast.

Input/output: float images in [0, 1], NHWC.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..ops.resample import grid_sample_bilinear
from ..utils.tensors import device_constant

# op indices
_IDENTITY, _SHEAR_X, _SHEAR_Y, _TRANS_X, _TRANS_Y, _ROTATE = 0, 1, 2, 3, 4, 5
_BRIGHT, _COLOR, _CONTRAST, _SHARP = 6, 7, 8, 9
_POSTERIZE, _SOLARIZE, _AUTOCONTRAST, _EQUALIZE = 10, 11, 12, 13
NUM_OPS = 14

_GRAY_W = (0.299, 0.587, 0.114)
_SMOOTH = tuple(v / 13.0 for v in (1, 1, 1, 1, 5, 1, 1, 1, 1))  # PIL SMOOTH
_KNOTS = 64


def sample_ta_wide(generator, b):
    """Per-image op index [B] (int64) and signed magnitude [B] (float32),
    on the generator's device."""
    dev = generator.device
    op = torch.randint(0, NUM_OPS, (b,), generator=generator, device=dev)
    u = torch.rand((b,), generator=generator, device=dev)
    sign = torch.rand((b,), generator=generator, device=dev) < 0.5
    return op, torch.where(sign, u, -u)


def _affine_grids(op, mag, h, w):
    """Per-image output->input affine sampling grid [B, h, w, 2] (y, x)."""
    is_sx, is_sy = op == _SHEAR_X, op == _SHEAR_Y
    is_tx, is_ty, is_rot = op == _TRANS_X, op == _TRANS_Y, op == _ROTATE
    zero = torch.zeros_like(mag)
    shear = mag * 0.99
    trans = mag * 32.0
    theta = mag * 135.0 * math.pi / 180.0
    # rotation about the center, PIL rotate(angle) = CCW
    cos_t = torch.where(is_rot, torch.cos(theta), zero + 1.0)
    sin_t = torch.where(is_rot, torch.sin(theta), zero)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    a = cos_t
    bb = torch.where(is_sx, shear, zero) + torch.where(is_rot, sin_t, zero)
    d = torch.where(is_sy, shear, zero) - torch.where(is_rot, sin_t, zero)
    e = cos_t
    c = torch.where(is_tx, trans, zero)
    f = torch.where(is_ty, trans, zero)
    oy = torch.where(is_rot, zero + cy, zero)[:, None, None]
    ox = torch.where(is_rot, zero + cx, zero)[:, None, None]

    ys = torch.arange(h, dtype=torch.float32, device=mag.device)[None, :, None]
    xs = torch.arange(w, dtype=torch.float32, device=mag.device)[None, None, :]
    # rotate around the center; shears/translates use PIL's top-left origin
    x_rel = xs - ox
    y_rel = ys - oy
    src_x = (a[:, None, None] * x_rel + bb[:, None, None] * y_rel
             + c[:, None, None] + ox)
    src_y = (d[:, None, None] * x_rel + e[:, None, None] * y_rel
             + f[:, None, None] + oy)
    return torch.stack(torch.broadcast_tensors(src_y, src_x), dim=-1)


def _knots(device):
    """``jnp.linspace(0, 1, 64)`` in float32: i * (1/63), the last knot 1."""
    k = torch.arange(_KNOTS, dtype=torch.float32, device=device) * (
        1.0 / (_KNOTS - 1))
    k[-1] = 1.0
    return k


def _equalize_cdf(x, knots=_KNOTS):
    """Approximate per-channel histogram equalization via a CDF lookup.

    ``cdf[b, c, k]`` is the share of the image's channel at or below knot k;
    each pixel maps to the CDF linearly interpolated at its value."""
    b, h, w, c = x.shape
    levels = _knots(x.device)
    # first knot at or above each pixel (``knots`` when above them all)
    first = torch.searchsorted(levels, x.contiguous(), right=False)
    plane = (torch.arange(b * c, device=x.device).view(b, 1, 1, c) * (knots + 1))
    counts = torch.zeros(b * c * (knots + 1), dtype=torch.float32, device=x.device)
    counts.index_add_(0, (plane + first).reshape(-1),
                      torch.ones(first.numel(), dtype=torch.float32, device=x.device))
    cdf = counts.view(b * c, knots + 1)[:, :knots].cumsum(-1) / float(h * w)
    pos = x.clamp(0.0, 1.0) * (knots - 1)
    i0 = torch.floor(pos)
    frac = pos - i0
    i0 = i0.long()
    i1 = (i0 + 1).clamp_max(knots - 1)
    base = plane // (knots + 1) * knots
    flat = cdf.reshape(-1)
    return flat[base + i0] * (1 - frac) + flat[base + i1] * frac


def ta_wide_apply(images, op, mag):
    """images: [B, H, W, 3] float in [0, 1]; op [B], mag [B] from
    ``sample_ta_wide``. Returns the augmented batch, same shape and dtype."""
    b, h, w, _ = images.shape
    x = images.float()

    # ---- geometric family: one batched grid sample ------------------------
    geo = ((op >= _SHEAR_X) & (op <= _ROTATE))[:, None, None, None]
    warped = grid_sample_bilinear(x, _affine_grids(op, mag, h, w))
    out = torch.where(geo, warped, x)

    s = mag[:, None, None, None]
    m = s.abs()

    def select(idx, val):
        return torch.where((op == idx)[:, None, None, None], val, out)

    # ---- photometric family -----------------------------------------------
    out = select(_BRIGHT, (out * (1.0 + s * 0.99)).clamp(0.0, 1.0))

    gray_w = device_constant(_GRAY_W, torch.float32, x.device)
    gray = (out @ gray_w)[..., None]
    out = select(_COLOR, (gray + (1.0 + s * 0.99) * (out - gray)).clamp(0, 1))

    mean_gray = gray.mean(dim=(1, 2, 3), keepdim=True)
    out = select(_CONTRAST,
                 (mean_gray + (1.0 + s * 0.99) * (out - mean_gray)).clamp(0, 1))

    # sharpness: PIL SMOOTH kernel [[1,1,1],[1,5,1],[1,1,1]]/13, zero-padded
    kern = device_constant(_SMOOTH, torch.float32, x.device).view(1, 1, 3, 3)
    smooth = F.conv2d(out.permute(0, 3, 1, 2), kern.expand(3, 1, 3, 3),
                      padding=1, groups=3).permute(0, 2, 3, 1)
    out = select(_SHARP, (smooth + (1.0 + s * 0.99) * (out - smooth)).clamp(0, 1))

    # posterize: keep `bits` high bits, TA-wide range 8 -> 2
    bits = torch.round(8.0 - m * 6.0)
    shift = 2.0 ** (8.0 - bits)
    out = select(_POSTERIZE, torch.floor(torch.floor(out * 255.0) / shift)
                 * shift / 255.0)

    # solarize: invert above threshold, TA-wide range 255 -> 0
    out = select(_SOLARIZE, torch.where(out >= 1.0 - m, 1.0 - out, out))

    lo = out.amin(dim=(1, 2), keepdim=True)
    hi = out.amax(dim=(1, 2), keepdim=True)
    out = select(_AUTOCONTRAST, (out - lo) / (hi - lo).clamp_min(1e-6))

    out = select(_EQUALIZE, _equalize_cdf(out))
    return out.to(images.dtype)
