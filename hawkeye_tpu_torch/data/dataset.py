"""Datasets driven by plain-text metadata lists.

Reference: ``dataset/dataset.py:22-64`` — lines are ``"<label> <relpath>"``
(space separated, comma fallback), images PIL-loaded as RGB, item is a dict
``{'img', 'label'[, 'id']}``. Metadata lists for the 8 benchmark datasets live
in ``metadata/`` (same format).

Additions over the reference, as in the JAX package:
- ``decode_size``: when set, the dataset performs only decode + fixed-size
  host prep (resize-shorter + center crop with PIL) and returns uint8
  arrays; the rest of the augmentation runs batched on the device
  (``transforms_device.py``).
- ``SyntheticDataset``: deterministic random images, so trainers/benchmarks
  run end-to-end without the (non-redistributable) image files.
"""

from __future__ import annotations

import os

import numpy as np
from PIL import Image

from .transforms_host import center_crop, resize_shorter


def parse_metadata(meta_path):
    """Parse a metadata list file → (labels int array, relative paths list)."""
    labels, paths = [], []
    with open(meta_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if " " in line:
                lab, path = line.split(" ", 1)
            elif "," in line:
                lab, path = line.split(",", 1)
            else:
                raise ValueError(f"unparseable metadata line: {line!r}")
            labels.append(int(lab))
            paths.append(path.strip())
    return np.asarray(labels, np.int64), paths


def load_rgb(path):
    """Decode an image file to RGB PIL (closes the fd eagerly, reference
    ``dataset/dataset.py:8-13`` webfg_loader behavior)."""
    with open(path, "rb") as f:
        img = Image.open(f)
        return img.convert("RGB")


class FGDataset:
    """Generic fine-grained dataset over a metadata list.

    Args:
      root: image root directory.
      meta_path: metadata list file.
      transform: host transform (PIL → np array). Used in 'host' pipeline mode.
      decode_size: if not None, ignore ``transform`` and return uint8
        [decode_size, decode_size, 3] (resize-shorter + center-crop) for the
        device pipeline.
      return_id: include the index as 'id' (reference return_id flag).
    """

    def __init__(self, root, meta_path, transform=None, decode_size=None,
                 return_id=False):
        self.root = root
        self.labels, self.paths = parse_metadata(meta_path)
        self.transform = transform
        self.decode_size = decode_size
        self.return_id = return_id

    @property
    def num_classes(self):
        return int(self.labels.max()) + 1

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, index):
        path = os.path.join(self.root, self.paths[index])
        img = load_rgb(path)
        if self.decode_size is not None:
            img = center_crop(resize_shorter(img, self.decode_size),
                              self.decode_size)
            arr = np.asarray(img, np.uint8)
        elif self.transform is not None:
            arr = self.transform(img)
        else:
            arr = np.asarray(img, np.uint8)
        data = {"img": arr, "label": int(self.labels[index])}
        if self.return_id:
            data["id"] = index
        return data


class SyntheticDataset:
    """Deterministic fake data with the FGDataset item contract."""

    def __init__(self, length=256, num_classes=200, image_size=448,
                 transform=None, decode_size=None, return_id=False, seed=0):
        self.length = length
        self._num_classes = num_classes
        self.image_size = image_size
        self.transform = transform
        self.decode_size = decode_size
        self.return_id = return_id
        rng = np.random.RandomState(seed)
        self.labels = rng.randint(0, num_classes, size=length).astype(np.int64)

    @property
    def num_classes(self):
        return self._num_classes

    def __len__(self):
        return self.length

    def __getitem__(self, index):
        size = self.decode_size or self.image_size
        rng = np.random.RandomState(index * 9973 + 7)
        arr = rng.randint(0, 256, size=(size, size, 3), dtype=np.uint8)
        if self.decode_size is None:  # else uint8 stays raw for the device
            if self.transform is not None:
                arr = self.transform(Image.fromarray(arr))
            else:
                arr = arr.astype(np.float32) / 255.0
        data = {"img": arr, "label": int(self.labels[index])}
        if self.return_id:
            data["id"] = index
        return data
