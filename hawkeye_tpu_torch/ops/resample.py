"""Batched crop + resize and grid sampling.

Counterpart of ``hawkeye_tpu/ops/resample.py``. The JAX package computes
these with XLA (batched matrix products and a gather), outside any Pallas
kernel, and so does the port:

- ``crop_resize_bilinear``: separable bilinear interpolation as two batched
  matrix products ``Wy @ img @ Wx^T`` (``torch.bmm``), so one call is
  RandomResizedCrop, center crop or box crop for a whole batch, with an
  optional per-image horizontal flip folded into the x-weights. The first
  product contracts the rows, its result rounds to ``dtype``, the second
  contracts the columns: JAX's order. AP-CNN's union-box crop of its
  stride-8 feature map is one of these.
- ``resize_bilinear``: a full-image resize by the same products, with the
  weights made once per shape as XLA folds the JAX package's constant boxes
  (S3N's class maps and grids, MGE-CNN's CAM).
- ``crop_resize_multibox``: M boxes per image from the one image, the M axis
  carried by the weight matrices (NTS-Net's part crops), in the same order.
- ``grid_sample_bilinear``: general bilinear grid sampling by a 4-tap gather
  from a zero-padded copy, for the per-image affine warps of TA-wide.
- ``resize_nearest``: nearest-neighbour resize by a gather of rows and
  columns (CrossX's cross-layer fusion).

Coordinates follow ``align_corners=False`` (torchvision / ``F.interpolate``
default) unless asked otherwise. Images are NHWC.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils.tensors import device_constant


def _reciprocal(n: int) -> float:
    """``1 / n`` rounded to float32."""
    return float(np.float32(1.0) / np.float32(n))


def _bilinear_weights(starts, sizes, in_size: int, out_size: int, dtype,
                      align_corners=False):
    """Per-image 1-D bilinear interpolation matrices [B, out_size, in_size]:
    ``W @ v`` resamples ``v`` from the window [start, start+size) to
    ``out_size`` points, with samples clamped to the window (intersected
    with the image) and rows renormalised where the clamp leaves mass < 1."""
    starts = starts.float()[:, None]
    sizes = sizes.float()[:, None]
    j = torch.arange(out_size, dtype=torch.float32, device=starts.device)[None, :]
    # the source coordinates as XLA computes the JAX expressions: the
    # division by a constant as a product with its float32 reciprocal, and
    # start + j * scale as one fused multiply-add (``addcmul``); separate
    # operations land one float32 ulp apart at coordinates of a few hundred
    if align_corners:
        scale = (sizes - 1.0) * _reciprocal(max(out_size - 1, 1))
        src = torch.addcmul(starts, j, scale)
    else:
        scale = sizes * _reciprocal(out_size)
        src = torch.addcmul(starts, j + 0.5, scale) - 0.5
    lo = starts.clamp(0.0, float(in_size - 1))
    hi = (starts + sizes - 1.0).clamp(0.0, float(in_size - 1))
    src = torch.minimum(torch.maximum(src, lo), hi)
    i0 = torch.floor(src)
    frac = src - i0
    i = torch.arange(in_size, dtype=torch.float32, device=starts.device)[None, None, :]
    w0 = (1.0 - (i - i0[..., None]).abs()).clamp(0.0, 1.0) * (1.0 - frac[..., None])
    w1 = (1.0 - (i - (i0[..., None] + 1.0)).abs()).clamp(0.0, 1.0) * frac[..., None]
    w = w0 + w1
    w = w / w.sum(-1, keepdim=True).clamp_min(1e-6)
    return w.to(dtype)


def crop_resize_bilinear(images, boxes, out_h: int, out_w: int, dtype=None,
                         align_corners=False, flip_x_mask=None):
    """Crop per-image boxes and resize to (out_h, out_w), fully batched.

    Args:
      images: [B, H, W, C] (float or uint8).
      boxes: [B, 4] (y0, x0, h, w) in pixels of the source image.
      flip_x_mask: optional [B] bool: flip that image horizontally, by
        reversing its x-weight rows.

    Returns [B, out_h, out_w, C] in ``dtype`` (the images' float dtype, or
    float32 for integer images), contiguous NHWC.
    """
    b, h, w, c = images.shape
    if dtype is None:
        dtype = images.dtype if images.is_floating_point() else torch.float32
    imgs = images.to(dtype)
    wy = _bilinear_weights(boxes[:, 0], boxes[:, 2], h, out_h, dtype,
                           align_corners)  # [B, oh, H]
    wx = _bilinear_weights(boxes[:, 1], boxes[:, 3], w, out_w, dtype,
                           align_corners)  # [B, ow, W]
    if flip_x_mask is not None:
        wx = torch.where(flip_x_mask[:, None, None], wx.flip(1), wx)
    return _separable(imgs, wy, wx)


def _separable(imgs, wy, wx):
    """``Wy @ img @ Wx^T`` per image: imgs [B, H, W, C], wy [B, oh, H], wx
    [B, ow, W] in the images' dtype."""
    b, h, w, c = imgs.shape
    out_h, out_w = wy.shape[1], wx.shape[1]
    # rows first, computed transposed: [B, W*C, H] @ [B, H, oh] -> [B, W*C, oh]
    # (both operands are transposed views; bmm reads them in place)
    tmp = torch.bmm(imgs.reshape(b, h, w * c).transpose(1, 2), wy.transpose(1, 2))
    # columns: [B, ow, W] @ [B, W, C*oh] -> [B, ow, C*oh]
    out = torch.bmm(wx, tmp.view(b, w, c * out_h))
    return out.view(b, out_w, c, out_h).permute(0, 3, 1, 2).contiguous()


def crop_resize_multibox(images, boxes, out_h: int, out_w: int, dtype=None,
                         align_corners=False):
    """Crop M boxes per image without copying the image M times.

    images: [B, H, W, C]; boxes: [B, M, 4] (y0, x0, h, w) in pixels.
    Returns [B, M, out_h, out_w, C] in ``dtype`` (as
    ``crop_resize_bilinear``): the rows of every box first, rounded to
    ``dtype``, then its columns.
    """
    b, h, w, c = images.shape
    m = boxes.shape[1]
    if dtype is None:
        dtype = images.dtype if images.is_floating_point() else torch.float32
    imgs = images.to(dtype)
    flat = boxes.reshape(b * m, 4)
    wy = _bilinear_weights(flat[:, 0], flat[:, 2], h, out_h, dtype,
                           align_corners)  # [B*M, oh, H]
    wx = _bilinear_weights(flat[:, 1], flat[:, 3], w, out_w, dtype,
                           align_corners)  # [B*M, ow, W]
    # rows: [B, M*oh, H] @ [B, H, W*C] -> [B, M*oh, W*C]
    tmp = torch.bmm(wy.reshape(b, m * out_h, h), imgs.reshape(b, h, w * c))
    # columns: [B*M, ow, W] @ [B*M, W, oh*C] -> [B*M, ow, oh*C]
    tmp = tmp.reshape(b * m, out_h, w, c).transpose(1, 2).reshape(
        b * m, w, out_h * c)
    out = torch.bmm(wx, tmp).reshape(b, m, out_w, out_h, c)
    return out.transpose(2, 3).contiguous()


@functools.lru_cache(maxsize=None)
def _full_image_weights(in_size: int, out_size: int, align_corners: bool,
                        dtype: torch.dtype, device: torch.device):
    """The weights [out_size, in_size] of a full-image resize, made on the
    host once per shape. The JAX package's full-image boxes are constants,
    which XLA folds: a true float32 division for the scale and one rounding
    of the source coordinate (``j * scale``, or ``(j + 0.5) * scale - 0.5``),
    an ulp from the runtime boxes' coordinates at some sizes (14 -> 31, 7 ->
    224). The rest is ``_bilinear_weights``' float32 arithmetic."""
    f32 = np.float32
    j = np.arange(out_size, dtype=np.float64)
    if align_corners:
        scale = f32(f32(in_size - 1) / f32(max(out_size - 1, 1)))
        src = (j * np.float64(scale)).astype(f32)
    else:
        scale = f32(f32(in_size) / f32(out_size))
        src = ((j + 0.5) * np.float64(scale) - 0.5).astype(f32)
    src = np.clip(src, f32(0), f32(in_size - 1))
    i0 = np.floor(src)
    frac = src - i0
    i = np.arange(in_size, dtype=f32)[None, :]
    w0 = np.clip(f32(1) - np.abs(i - i0[:, None]), f32(0), f32(1)) * (f32(1) - frac)[:, None]
    w1 = np.clip(f32(1) - np.abs(i - (i0[:, None] + f32(1))), f32(0), f32(1)) * frac[:, None]
    w = w0 + w1
    w = w / np.maximum(w.sum(-1, keepdims=True), f32(1e-6))
    return torch.from_numpy(w).to(device=device, dtype=dtype)


def resize_bilinear(images, out_h: int, out_w: int, dtype=None,
                    align_corners=False):
    """Plain full-image resize, with the weights the JAX package's jitted
    function uses (``_full_image_weights``)."""
    b, h, w, _ = images.shape
    if dtype is None:
        dtype = images.dtype if images.is_floating_point() else torch.float32
    wy = _full_image_weights(h, out_h, bool(align_corners), dtype, images.device)
    wx = _full_image_weights(w, out_w, bool(align_corners), dtype, images.device)
    return _separable(images.to(dtype), wy.expand(b, -1, -1), wx.expand(b, -1, -1))


def grid_sample_bilinear(images, grid):
    """Bilinear grid sample with zero padding outside the image.

    Args:
      images: [B, H, W, C] float.
      grid: [B, out_h, out_w, 2] sample coordinates in pixels, last dim (y, x).

    A tap at row or column -1 or H/W reads the zero ring of a padded copy;
    samples further out are masked to zero, as in the JAX gather.
    """
    b, h, w, c = images.shape
    out_sp = grid.shape[1:-1]
    y = grid[..., 0].reshape(b, -1)
    x = grid[..., 1].reshape(b, -1)
    y0 = torch.floor(y)
    x0 = torch.floor(x)
    wy1 = (y - y0).to(images.dtype)[..., None]
    wx1 = (x - x0).to(images.dtype)[..., None]
    xp = torch.nn.functional.pad(images, (0, 0, 1, 1, 1, 1)).reshape(
        b, (h + 2) * (w + 2), c)
    iy = (y0 + 1).clamp(0, h).long()
    ix = (x0 + 1).clamp(0, w).long()

    def tap(dy, dx):
        flat = ((iy + dy) * (w + 2) + ix + dx)[..., None].expand(-1, -1, c)
        return torch.gather(xp, 1, flat)

    ok = ((y0 >= -1) & (y0 <= h - 1) & (x0 >= -1) & (x0 <= w - 1)).to(
        images.dtype)[..., None]
    top = tap(0, 0) * (1 - wx1) + tap(0, 1) * wx1
    bot = tap(1, 0) * (1 - wx1) + tap(1, 1) * wx1
    out = (top * (1 - wy1) + bot * wy1) * ok
    return out.reshape(b, *out_sp, c)


def nearest_index(in_size: int, out_size: int) -> np.ndarray:
    """Source rows of a nearest resize, ``floor(dst * in/out)``, computed as
    the JAX package computes them: an int32 ``arange`` times the Python float
    ``in/out``, which JAX takes as float32. In float64 the index differs at
    some sizes (2 -> 82, 3 -> 123); ``F.interpolate`` is not used for the
    same reason."""
    src = np.arange(out_size, dtype=np.float32) * np.float32(in_size / out_size)
    return np.floor(src).astype(np.int64)


def resize_nearest(images, out_h: int, out_w: int):
    """Nearest-neighbour resize of NHWC ``images`` to (out_h, out_w), the
    counterpart of the JAX package's ``resize_nearest``
    (``F.interpolate(mode='nearest')``'s rule): a gather of rows, then of
    columns, with the indices made on the host once per shape."""
    _, h, w, _ = images.shape
    iy = device_constant(tuple(nearest_index(h, out_h).tolist()), torch.long,
                         images.device)
    ix = device_constant(tuple(nearest_index(w, out_w).tolist()), torch.long,
                         images.device)
    return images.index_select(1, iy).index_select(2, ix)
