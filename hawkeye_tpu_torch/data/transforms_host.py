"""Host-side (PIL/numpy) image transforms — the accuracy-parity path.

Mirrors the behavior of the reference's torchvision presets
(``dataset/transforms.py:14-73``): train = RandomResizedCrop + HFlip +
TrivialAugmentWide (default) + normalize + RandomErasing(p=0.1); eval =
Resize(shorter side) + CenterCrop + normalize. Defaults match the base
Trainer's choices (``train.py:171-183``).

Everything outputs **NHWC float32 numpy** (not CHW): the models take NHWC
and lay it out on the device as they need.
"""

from __future__ import annotations

import math
import random

import numpy as np
from PIL import Image, ImageEnhance, ImageOps

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

_BILINEAR = Image.BILINEAR


# --------------------------------------------------------------------------
# basic geometry
# --------------------------------------------------------------------------
def resize_shorter(img: Image.Image, size: int) -> Image.Image:
    w, h = img.size
    if w <= h:
        nw, nh = size, max(1, round(h * size / w))
    else:
        nw, nh = max(1, round(w * size / h)), size
    return img.resize((nw, nh), _BILINEAR)


def center_crop(img: Image.Image, size: int) -> Image.Image:
    w, h = img.size
    left = (w - size) // 2
    top = (h - size) // 2
    return img.crop((left, top, left + size, top + size))


def random_resized_crop(img: Image.Image, size: int, scale=(0.08, 1.0),
                        ratio=(3 / 4, 4 / 3)) -> Image.Image:
    """torchvision RandomResizedCrop semantics (10 tries then center fallback)."""
    w, h = img.size
    area = w * h
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        target_area = area * random.uniform(*scale)
        aspect = math.exp(random.uniform(*log_ratio))
        cw = int(round(math.sqrt(target_area * aspect)))
        ch = int(round(math.sqrt(target_area / aspect)))
        if 0 < cw <= w and 0 < ch <= h:
            left = random.randint(0, w - cw)
            top = random.randint(0, h - ch)
            return img.resize((size, size), _BILINEAR,
                              box=(left, top, left + cw, top + ch))
    # fallback: largest center crop with in-range aspect
    in_ratio = w / h
    if in_ratio < ratio[0]:
        cw, ch = w, int(round(w / ratio[0]))
    elif in_ratio > ratio[1]:
        cw, ch = int(round(h * ratio[1])), h
    else:
        cw, ch = w, h
    left = (w - cw) // 2
    top = (h - ch) // 2
    return img.resize((size, size), _BILINEAR, box=(left, top, left + cw, top + ch))


# --------------------------------------------------------------------------
# TrivialAugmentWide (torchvision semantics: pick ONE op, uniform strength)
# --------------------------------------------------------------------------
def _affine(img, data):
    return img.transform(img.size, Image.AFFINE, data, resample=_BILINEAR)


def _ta_ops():
    return {
        "Identity": lambda img, m: img,
        "ShearX": lambda img, m: _affine(img, (1, m, 0, 0, 1, 0)),
        "ShearY": lambda img, m: _affine(img, (1, 0, 0, m, 1, 0)),
        "TranslateX": lambda img, m: _affine(img, (1, 0, m, 0, 1, 0)),
        "TranslateY": lambda img, m: _affine(img, (1, 0, 0, 0, 1, m)),
        "Rotate": lambda img, m: img.rotate(m, resample=_BILINEAR),
        "Brightness": lambda img, m: ImageEnhance.Brightness(img).enhance(1.0 + m),
        "Color": lambda img, m: ImageEnhance.Color(img).enhance(1.0 + m),
        "Contrast": lambda img, m: ImageEnhance.Contrast(img).enhance(1.0 + m),
        "Sharpness": lambda img, m: ImageEnhance.Sharpness(img).enhance(1.0 + m),
        "Posterize": lambda img, m: ImageOps.posterize(img, max(1, int(m))),
        "Solarize": lambda img, m: ImageOps.solarize(img, int(m)),
        "AutoContrast": lambda img, m: ImageOps.autocontrast(img),
        "Equalize": lambda img, m: ImageOps.equalize(img),
    }


# (min, max, signed) magnitude spaces, TrivialAugmentWide ranges
_TA_WIDE_SPACE = {
    "Identity": (0.0, 0.0, False),
    "ShearX": (0.0, 0.99, True),
    "ShearY": (0.0, 0.99, True),
    "TranslateX": (0.0, 32.0, True),
    "TranslateY": (0.0, 32.0, True),
    "Rotate": (0.0, 135.0, True),
    "Brightness": (0.0, 0.99, True),
    "Color": (0.0, 0.99, True),
    "Contrast": (0.0, 0.99, True),
    "Sharpness": (0.0, 0.99, True),
    "Posterize": (8.0, 2.0, False),
    "Solarize": (255.0, 0.0, False),
    "AutoContrast": (0.0, 0.0, False),
    "Equalize": (0.0, 0.0, False),
}


def trivial_augment_wide(img: Image.Image) -> Image.Image:
    ops = _ta_ops()
    name = random.choice(list(_TA_WIDE_SPACE))
    lo, hi, signed = _TA_WIDE_SPACE[name]
    m = lo + (hi - lo) * random.random()
    if signed and random.random() < 0.5:
        m = -m
    return ops[name](img, m)


# AutoAugment ImageNet policy: 25 sub-policies of (op, probability,
# magnitude bin/10 within the op's TA range). Torchvision's table, expressed
# against the shared op set above.
_AA_IMAGENET = [
    (("Posterize", 0.4, 8), ("Rotate", 0.6, 9)),
    (("Solarize", 0.6, 5), ("AutoContrast", 0.6, None)),
    (("Equalize", 0.8, None), ("Equalize", 0.6, None)),
    (("Posterize", 0.6, 7), ("Posterize", 0.6, 6)),
    (("Equalize", 0.4, None), ("Solarize", 0.2, 4)),
    (("Equalize", 0.4, None), ("Rotate", 0.8, 8)),
    (("Solarize", 0.6, 3), ("Equalize", 0.6, None)),
    (("Posterize", 0.8, 5), ("Equalize", 1.0, None)),
    (("Rotate", 0.2, 3), ("Solarize", 0.6, 8)),
    (("Equalize", 0.6, None), ("Posterize", 0.4, 6)),
    (("Rotate", 0.8, 8), ("Color", 0.4, 0)),
    (("Rotate", 0.4, 9), ("Equalize", 0.6, None)),
    (("Equalize", 0.0, None), ("Equalize", 0.8, None)),
    (("AutoContrast", 0.6, None), ("Equalize", 1.0, None)),
    (("Rotate", 0.8, 8), ("Color", 1.0, 2)),
    (("Color", 0.8, 8), ("Solarize", 0.8, 7)),
    (("Sharpness", 0.4, 7), ("AutoContrast", 0.6, None)),
    (("ShearX", 0.6, 5), ("Equalize", 1.0, None)),
    (("Color", 0.4, 0), ("Equalize", 0.6, None)),
    (("Equalize", 0.4, None), ("Solarize", 0.2, 4)),
    (("Solarize", 0.6, 5), ("AutoContrast", 0.6, None)),
    (("AutoContrast", 0.4, None), ("Solarize", 0.2, 8)),
    (("Equalize", 0.8, None), ("Invert", 0.1, None)),
    (("Color", 0.6, 4), ("Contrast", 1.0, 8)),
    (("Equalize", 0.8, None), ("Equalize", 0.6, None)),
]

# AutoAugment magnitude spaces differ from TA-wide (10 bins, tighter ranges)
_AA_SPACE = {
    "ShearX": (0.0, 0.3, True), "ShearY": (0.0, 0.3, True),
    "TranslateX": (0.0, 150.0, True), "TranslateY": (0.0, 150.0, True),
    "Rotate": (0.0, 30.0, True),
    "Brightness": (0.0, 0.9, True), "Color": (0.0, 0.9, True),
    "Contrast": (0.0, 0.9, True), "Sharpness": (0.0, 0.9, True),
    "Posterize": (8.0, 4.0, False), "Solarize": (255.0, 0.0, False),
    "AutoContrast": (0.0, 0.0, False), "Equalize": (0.0, 0.0, False),
    "Invert": (0.0, 0.0, False),
}


def auto_augment(img: Image.Image) -> Image.Image:
    """AutoAugment with the ImageNet policy (torchvision semantics)."""
    ops = _ta_ops()
    ops["Invert"] = lambda im, m: ImageOps.invert(im)
    sub = random.choice(_AA_IMAGENET)
    for name, prob, bin10 in sub:
        if random.random() > prob:
            continue
        lo, hi, signed = _AA_SPACE[name]
        m = lo if bin10 is None else lo + (hi - lo) * (bin10 / 9.0)
        if signed and random.random() < 0.5:
            m = -m
        img = ops[name](img, m)
    return img


def rand_augment(img: Image.Image, num_ops=2, magnitude=9) -> Image.Image:
    """RandAugment (fixed magnitude out of 31 bins), torchvision flavor."""
    ops = _ta_ops()
    frac = magnitude / 31.0
    for _ in range(num_ops):
        name = random.choice(list(_TA_WIDE_SPACE))
        lo, hi, signed = _TA_WIDE_SPACE[name]
        m = lo + (hi - lo) * frac
        if signed and random.random() < 0.5:
            m = -m
        img = ops[name](img, m)
    return img


# --------------------------------------------------------------------------
# tensor-space ops
# --------------------------------------------------------------------------
def to_float_array(img: Image.Image) -> np.ndarray:
    return np.asarray(img, np.uint8).astype(np.float32) / 255.0


def normalize(arr: np.ndarray, mean=IMAGENET_MEAN, std=IMAGENET_STD) -> np.ndarray:
    return (arr - mean) / std


def random_erase(arr: np.ndarray, p=0.1, scale=(0.02, 0.33), ratio=(0.3, 3.3),
                 value=0.0) -> np.ndarray:
    """torchvision RandomErasing on an HWC float array."""
    if random.random() >= p:
        return arr
    h, w, _ = arr.shape
    area = h * w
    log_ratio = (math.log(ratio[0]), math.log(ratio[1]))
    for _ in range(10):
        ea = area * random.uniform(*scale)
        ar = math.exp(random.uniform(*log_ratio))
        eh = int(round(math.sqrt(ea * ar)))
        ew = int(round(math.sqrt(ea / ar)))
        if eh < h and ew < w:
            top = random.randint(0, h - eh)
            left = random.randint(0, w - ew)
            arr = arr.copy()
            arr[top:top + eh, left:left + ew, :] = value
            return arr
    return arr


# --------------------------------------------------------------------------
# presets (reference: dataset/transforms.py:14-73; defaults train.py:171-183)
# --------------------------------------------------------------------------
class TrainPreset:
    """RandomResizedCrop(size) → HFlip(0.5) → aug policy → normalize → erase."""

    def __init__(self, crop_size: int, auto_augment_policy: str | None = "ta_wide",
                 random_erase_prob: float = 0.1, hflip_prob: float = 0.5,
                 mean=IMAGENET_MEAN, std=IMAGENET_STD, ra_magnitude=9,
                 random_resized_crop: bool = True, resize_size: int | None = None):
        self.crop_size = crop_size
        self.policy = auto_augment_policy
        self.erase_prob = random_erase_prob
        self.hflip_prob = hflip_prob
        self.mean, self.std = mean, std
        self.ra_magnitude = ra_magnitude
        self.rrc = random_resized_crop
        self.resize_size = resize_size or crop_size * 8 // 7

    def __call__(self, img: Image.Image) -> np.ndarray:
        if self.rrc:
            img = random_resized_crop(img, self.crop_size)
        else:
            # deterministic geometry (rrc: false): eval-style resize+center
            # crop, for pipelines that must see a fixed view per sample
            img = resize_shorter(img, self.resize_size)
            img = center_crop(img, self.crop_size)
        if random.random() < self.hflip_prob:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
        if self.policy == "ta_wide":
            img = trivial_augment_wide(img)
        elif self.policy == "ra":
            img = rand_augment(img, magnitude=self.ra_magnitude)
        elif self.policy in ("aa", "imagenet"):
            img = auto_augment(img)
        elif self.policy in (None, "none"):
            pass
        else:
            raise ValueError(f"unknown auto_augment policy {self.policy!r}")
        arr = normalize(to_float_array(img), self.mean, self.std)
        if self.erase_prob > 0:
            arr = random_erase(arr, p=self.erase_prob)
        return arr.astype(np.float32)


class EvalPreset:
    """Resize(resize_size, shorter side) → CenterCrop(crop_size) → normalize."""

    def __init__(self, crop_size: int, resize_size: int,
                 mean=IMAGENET_MEAN, std=IMAGENET_STD):
        self.crop_size = crop_size
        self.resize_size = resize_size
        self.mean, self.std = mean, std

    def __call__(self, img: Image.Image) -> np.ndarray:
        img = resize_shorter(img, self.resize_size)
        img = center_crop(img, self.crop_size)
        return normalize(to_float_array(img), self.mean, self.std).astype(np.float32)


def build_transforms(transformer_config):
    """Config → (train_transform, eval_transform).

    Config keys follow the reference's ``dataset.transformer`` node:
    ``image_size`` (crop), ``resize_size`` (default: image_size * 8 // 7,
    matching torchvision's 224→256 convention the configs use), plus our
    optional ``auto_augment`` / ``random_erase``.
    """
    image_size = transformer_config.image_size
    resize_size = transformer_config.get("resize_size", image_size * 8 // 7)
    policy = transformer_config.get("auto_augment", "ta_wide")
    erase = transformer_config.get("random_erase", 0.1)
    train_t = TrainPreset(
        image_size, auto_augment_policy=policy, random_erase_prob=erase,
        hflip_prob=transformer_config.get("hflip", 0.5),
        random_resized_crop=transformer_config.get("rrc", True),
        resize_size=resize_size)
    eval_t = EvalPreset(image_size, resize_size)
    return train_t, eval_t
