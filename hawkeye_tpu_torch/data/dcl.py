"""DCL destruction (jigsaw swap) data machinery.

Counterpart of ``hawkeye_tpu/data/dcl.py`` (reference
``dataset/dataset_DCL.py`` and ``dataset/transforms.py:243-319``): each
image, after the common augmentation, gets a grid x grid jigsaw whose cells
move only locally (``neighborhood_permutation``), and the batch doubles to
``[unswapped; swapped]`` with class labels, swap labels (unswapped 1,
swapped 0 with ``cls_2``; else ``label`` and ``label + C``) and swap laws
(each position's original cell index, centred and over the cell count; the
permutation is known, so the law is exact).

Two pipelines share that law:

- host (numpy and PIL, the reference's path): ``DCLCommonAug`` (resize to
  R x R, rotate +-15 degrees, crop S, flip) per image, then the collates.
  They are copies of the JAX package's, bit-equal on the same
  ``np.random.RandomState`` and Python ``random`` seeds.
- device (torch, ``dataset.pipeline: device``): the host decodes uint8
  ``[B, R, R, 3]``; ``make_dcl_device_augment`` rotates and crops in one
  output-to-input bilinear sample (``ops/resample.grid_sample_bilinear``,
  PIL's counter-clockwise angle, zero fill), flips, builds the jigsaw by a
  gather and the 2x batch, and normalises. The draws come from a
  ``torch.Generator`` (``sample_dcl_draws``) apart from their application
  (``apply_dcl_augment``), so the tests can feed the JAX package's draws;
  the two packages' random streams differ. ``make_dcl_device_eval`` crops
  the centre and normalises.
"""

from __future__ import annotations

import math
import random

import numpy as np
import torch
from PIL import Image

from .transforms_device import hflip
from .transforms_device import normalize as device_normalize
from .transforms_host import IMAGENET_MEAN, IMAGENET_STD
from ..ops.resample import grid_sample_bilinear
from ..utils.tensors import device_constant


def neighborhood_permutation(rng, grid=7, ran=2):
    """Local jigsaw permutation of a grid x grid board: each cell's sort key
    is its index + U(-ran, ran), sorted along rows, then along columns.
    ``perm[i]`` is the original cell now at position i."""
    base = np.arange(grid * grid).reshape(grid, grid)
    keys = np.arange(grid)[None, :] + rng.uniform(-ran, ran, size=(grid, grid))
    base = np.take_along_axis(base, np.argsort(keys, axis=1), axis=1)
    keys = np.arange(grid)[:, None] + rng.uniform(-ran, ran, size=(grid, grid))
    base = np.take_along_axis(base, np.argsort(keys, axis=0), axis=0)
    return base.reshape(-1)


def apply_jigsaw(img, perm, grid=7):
    """img [S, S, C] with S divisible by grid; perm [grid * grid]."""
    s = img.shape[0]
    assert s % grid == 0, f"image size {s} not divisible by grid {grid}"
    cell = s // grid
    c = img.shape[-1]
    patches = img.reshape(grid, cell, grid, cell, c).transpose(0, 2, 1, 3, 4)
    patches = patches.reshape(grid * grid, cell, cell, c)
    out = patches[perm].reshape(grid, grid, cell, cell, c)
    return out.transpose(0, 2, 1, 3, 4).reshape(s, s, c)


def swap_law(perm, grid=7):
    """law[i] = (original index of the cell at position i - mid) / n."""
    n = grid * grid
    return (perm.astype(np.float32) - n // 2) / n


def identity_law(grid=7):
    n = grid * grid
    return (np.arange(n, dtype=np.float32) - n // 2) / n


def _normalize(u8):
    return ((u8.astype(np.float32) / 255.0) - IMAGENET_MEAN) / IMAGENET_STD


def _weights(items):
    """Per-row sample weights, 1 unless an item carries its own."""
    return np.asarray([float(it.get("weight", 1.0)) for it in items], np.float32)


class DCLTrainCollate:
    """Items carry uint8 ``img`` [S, S, 3] after the common augmentation.
    Emits the 2x batch ``[unswapped; swapped]`` with labels, swap labels,
    laws and weights."""

    def __init__(self, grid=7, ran=2, cls_2=True, num_classes=None, seed=0):
        self.grid = grid
        self.ran = ran
        self.cls_2 = cls_2
        self.num_classes = num_classes
        self.rng = np.random.RandomState(seed)

    def __call__(self, items):
        imgs, swap_imgs, labels, laws, swap_laws, swap_labels = [], [], [], [], [], []
        for it in items:
            img = it["img"]
            label = int(it["label"])
            perm = neighborhood_permutation(self.rng, self.grid, self.ran)
            imgs.append(_normalize(img))
            swap_imgs.append(_normalize(apply_jigsaw(img, perm, self.grid)))
            labels.append(label)
            laws.append(identity_law(self.grid))
            swap_laws.append(swap_law(perm, self.grid))
            swap_labels.append((1, 0) if self.cls_2
                               else (label, label + self.num_classes))
        w = _weights(items)
        return {
            "img": np.stack(imgs + swap_imgs).astype(np.float32),
            "label": np.asarray(labels + labels, np.int64),
            "label_swap": np.asarray([s[0] for s in swap_labels]
                                     + [s[1] for s in swap_labels], np.int64),
            "swap_law": np.stack(laws + swap_laws).astype(np.float32),
            "weight": np.concatenate([w, w]),
        }


class DCLValCollate:
    """Unswapped images only: swap label 'unswapped' (or the class), the
    identity law."""

    def __init__(self, grid=7, cls_2=True):
        self.grid = grid
        self.cls_2 = cls_2

    def __call__(self, items):
        imgs = np.stack([_normalize(it["img"]) for it in items]).astype(np.float32)
        labels = np.asarray([int(it["label"]) for it in items], np.int64)
        law = np.stack([identity_law(self.grid)] * len(items)).astype(np.float32)
        return {"img": imgs, "label": labels,
                "label_swap": np.ones_like(labels) if self.cls_2 else labels,
                "swap_law": law, "weight": _weights(items)}


class DCLBackboneCollate:
    """Unswapped images and class labels (reference collate_fn4backbone,
    ``dataset_DCL.py:167-180``)."""

    def __call__(self, items):
        imgs = np.stack([_normalize(it["img"]) for it in items]).astype(np.float32)
        labels = np.asarray([int(it["label"]) for it in items], np.int64)
        return {"img": imgs, "label": labels, "weight": _weights(items)}


class DCLTestCollate(DCLBackboneCollate):
    """The eval collate (reference collate_fn4test, ``dataset_DCL.py:183-193``),
    the same batch as ``DCLBackboneCollate``'s."""


class DCLCommonAug:
    """Reference common_aug (``Examples/DCL.py:28-33``): Resize(R, R),
    RandomRotation(+-rotate), RandomCrop(S), HFlip, with Python's
    ``random``; eval resizes and crops the centre. Returns uint8 [S, S, 3]."""

    def __init__(self, resize_size=512, crop_size=448, rotate=15, train=True):
        self.resize_size = resize_size
        self.crop_size = crop_size
        self.rotate = rotate
        self.train = train

    def __call__(self, img: Image.Image) -> np.ndarray:
        img = img.resize((self.resize_size, self.resize_size), Image.BILINEAR)
        if self.train:
            if self.rotate:
                img = img.rotate(random.uniform(-self.rotate, self.rotate),
                                 resample=Image.BILINEAR)
            max_off = self.resize_size - self.crop_size
            left = random.randint(0, max_off)
            top = random.randint(0, max_off)
            img = img.crop((left, top, left + self.crop_size, top + self.crop_size))
            if random.random() < 0.5:
                img = img.transpose(Image.FLIP_LEFT_RIGHT)
        else:
            off = (self.resize_size - self.crop_size) // 2
            img = img.crop((off, off, off + self.crop_size, off + self.crop_size))
        return np.asarray(img, np.uint8)


def subsample_per_class(labels, fraction=0.1, seed=0):
    """Sorted indices of a ~``fraction`` per-class subsample (reference
    ``dataset_DCL.py:100-115``, the 10% val split)."""
    rng = np.random.RandomState(seed)
    labels = np.asarray(labels)
    keep = []
    for c in np.unique(labels):
        idx = np.flatnonzero(labels == c)
        k = max(len(idx) // int(round(1 / fraction)), 1)
        keep.extend(rng.choice(idx, size=k, replace=False))
    return np.sort(np.asarray(keep))


# ---------------------------------------------------------------------------
# the device pipeline
# ---------------------------------------------------------------------------
def permutations_from_keys(row_u, col_u, ran=2):
    """``neighborhood_permutation`` for a batch, from its two uniform draws
    in [0, 1) of shape [n, grid, grid]: keys index + U(-ran, ran), a stable
    argsort within rows, then within columns. Returns [n, grid * grid]."""
    n, grid, _ = row_u.shape
    idx = torch.arange(grid, dtype=torch.float32, device=row_u.device)
    base = torch.arange(grid * grid, device=row_u.device).reshape(1, grid, grid)
    base = base.expand(n, grid, grid)
    keys = idx[None, None, :] + (row_u * (2 * ran) - ran)
    base = base.gather(2, keys.argsort(dim=2, stable=True))
    keys = idx[None, :, None] + (col_u * (2 * ran) - ran)
    base = base.gather(1, keys.argsort(dim=1, stable=True))
    return base.reshape(n, -1)


def device_apply_jigsaw(imgs, perms, grid=7):
    """imgs [B, S, S, C] with S divisible by grid; perms [B, grid * grid]."""
    b, s, _, c = imgs.shape
    assert s % grid == 0, f"image size {s} not divisible by grid {grid}"
    cell = s // grid
    p = imgs.reshape(b, grid, cell, grid, cell, c).permute(0, 1, 3, 2, 4, 5)
    p = p.reshape(b, grid * grid, cell, cell, c)
    p = p[torch.arange(b, device=imgs.device)[:, None], perms]
    p = p.reshape(b, grid, grid, cell, cell, c).permute(0, 1, 3, 2, 4, 5)
    return p.reshape(b, s, s, c)


def device_swap_law(perms, grid=7):
    n = grid * grid
    return (perms.to(torch.float32) - n // 2) / n


def sample_dcl_draws(generator, b, r, s, rotate=15.0, grid=7, ran=2,
                     hflip_prob=0.5):
    """Every random draw of one DCL train augmentation of b decodes of side
    r into crops of side s: the angle in degrees, the crop's top and left,
    the flip mask and the jigsaw permutations."""
    dev = generator.device

    def uniform(*shape):
        return torch.rand(shape, generator=generator, device=dev)

    theta = uniform(b) * (2 * rotate) - rotate
    top = torch.randint(0, r - s + 1, (b,), generator=generator, device=dev)
    left = torch.randint(0, r - s + 1, (b,), generator=generator, device=dev)
    flip = uniform(b) < hflip_prob
    perms = permutations_from_keys(uniform(b, grid, grid), uniform(b, grid, grid), ran)
    return {"theta": theta, "top": top, "left": left, "flip": flip, "perms": perms}


def rotate_crop(imgs, theta_deg, top, left, s):
    """Rotate [B, R, R, C] by ``theta_deg`` about the image centre (PIL's
    counter-clockwise angle, zero fill) and crop [s, s] at (top, left), as
    one output-to-input bilinear sample."""
    r = imgs.shape[1]
    theta = theta_deg.to(torch.float32) * (math.pi / 180.0)
    c = (r - 1) / 2.0
    ar = torch.arange(s, dtype=torch.float32, device=imgs.device)
    ys = ar[None, :, None] + top.to(torch.float32)[:, None, None]
    xs = ar[None, None, :] + left.to(torch.float32)[:, None, None]
    cos_t = torch.cos(theta)[:, None, None]
    sin_t = torch.sin(theta)[:, None, None]
    src_x = cos_t * (xs - c) + sin_t * (ys - c) + c
    src_y = -sin_t * (xs - c) + cos_t * (ys - c) + c
    grid_yx = torch.stack(torch.broadcast_tensors(src_y, src_x), dim=-1)
    return grid_sample_bilinear(imgs, grid_yx)


def _identity_laws(b, grid, device):
    law = device_constant(tuple(identity_law(grid).tolist()), torch.float32, device)
    return law.expand(b, grid * grid)


def double_batch(batch, imgs, perms, grid=7, cls_2=True, num_classes=None):
    """The 2x batch of ``imgs`` [B, S, S, C] and their jigsaws by ``perms``:
    ``img`` [2B, S, S, C] ``[unswapped; swapped]`` with ``label``,
    ``label_swap``, ``swap_law`` and (when the batch has one) ``weight``,
    each doubled in the same order."""
    labels = batch["label"]
    new = dict(batch)
    new["img"] = torch.cat([imgs, device_apply_jigsaw(imgs, perms, grid)])
    new["label"] = torch.cat([labels, labels])
    if cls_2:
        new["label_swap"] = torch.cat([torch.ones_like(labels), torch.zeros_like(labels)])
    else:
        new["label_swap"] = torch.cat([labels, labels + int(num_classes)])
    new["swap_law"] = torch.cat([_identity_laws(imgs.shape[0], grid, imgs.device),
                                 device_swap_law(perms, grid)])
    if "weight" in batch:
        new["weight"] = torch.cat([batch["weight"], batch["weight"]])
    return new


def apply_dcl_augment(batch, draws, image_size, grid=7, cls_2=True,
                      num_classes=None):
    """The DCL train batch from uint8 ``img`` [B, R, R, 3] and ``draws``:
    rotated, cropped, flipped and normalised, then ``double_batch``."""
    imgs = batch["img"].to(torch.float32) / 255.0
    out = rotate_crop(imgs, draws["theta"], draws["top"], draws["left"], image_size)
    out = device_normalize(hflip(out, draws["flip"]))
    return double_batch(batch, out, draws["perms"], grid, cls_2, num_classes)


def make_dcl_device_augment(image_size, rotate=15.0, grid=7, ran=2, cls_2=True,
                            num_classes=None, hflip_prob=0.5):
    """``augment(generator, batch) -> 2x batch``: ``sample_dcl_draws`` then
    ``apply_dcl_augment``."""

    def augment(generator, batch):
        b, r = batch["img"].shape[:2]
        draws = sample_dcl_draws(generator, b, r, int(image_size), rotate, grid,
                                 ran, hflip_prob)
        return apply_dcl_augment(batch, draws, int(image_size), grid, cls_2,
                                 num_classes)

    return augment


def make_dcl_device_eval(image_size, grid=7, cls_2=True):
    """The DCL eval batch: the centre S crop, normalised, with the identity
    law and the 'unswapped' swap label (``DCLValCollate``'s batch)."""
    s = int(image_size)

    def prep(batch):
        raw = batch["img"]
        b, r = raw.shape[:2]
        off = (r - s) // 2
        new = dict(batch)
        new["img"] = device_normalize(
            raw[:, off:off + s, off:off + s, :].to(torch.float32) / 255.0)
        labels = batch["label"]
        new["label_swap"] = torch.ones_like(labels) if cls_2 else labels
        new["swap_law"] = _identity_laws(b, grid, raw.device)
        return new

    return prep
