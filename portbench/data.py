"""The benchmark's inputs, made from the seed: a pool of decoded images and
the index batches that the window's steps draw from it.

The pool stands for CUB-200 as the device pipeline's host side delivers it:
uint8 ``[R, R, 3]`` decodes (R = the recipe's ``resize_size``) with labels
over the configuration's classes. Each image is a smooth random field with
fine noise on top, made on the device in a few large calls and copied to
host memory once. JPEG decoding is not part of it (see ``PERF.md``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

CHUNK = 128  # images made per call


def make_pool(n, size, classes, seed, device):
    """(images uint8 [n, size, size, 3] in host memory, labels int64 [n])."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    images = np.empty((n, size, size, 3), dtype=np.uint8)
    for i in range(0, n, CHUNK):
        b = min(CHUNK, n - i)
        coarse = torch.rand((b, 3, 16, 16), generator=gen, device=device)
        field = F.interpolate(coarse, size=(size, size), mode="bilinear",
                              align_corners=False)
        noise = torch.rand((b, 3, size, size), generator=gen, device=device)
        img = ((0.8 * field + 0.2 * noise) * 255.0).to(torch.uint8)
        images[i:i + b] = img.permute(0, 2, 3, 1).cpu().numpy()
    labels = torch.randint(0, classes, (n,), generator=gen, device=device)
    return images, labels.cpu().numpy().astype(np.int64)


class PoolDataset:
    """The pool with the item contract of the port's datasets."""

    def __init__(self, images, labels):
        self.images = images
        self.labels = labels

    def __len__(self):
        return len(self.labels)

    def __getitem__(self, i):
        return {"img": self.images[i], "label": int(self.labels[i])}


class WindowSampler:
    """Global index batches over the pool, a fresh permutation of it per
    pass, drawn from the seed; ``plan(steps)`` sets how many batches the next
    epoch yields. Every rank holds the same sampler, so all agree on the
    global order (the port's ``ProcessShardedBatchSampler`` slices it)."""

    def __init__(self, n, batch, seed):
        if n % batch:
            raise ValueError(f"pool of {n} is not a whole number of batches of {batch}")
        self.n = n
        self.batch = batch
        self.rng = np.random.default_rng(seed)
        self.order = self.rng.permutation(n)
        self.cursor = 0
        self.steps = 0
        self.handed = 0  # rows handed out over the sampler's life
        self.log = None  # the batches of an epoch, when asked for

    def plan(self, steps, log=False):
        self.steps = int(steps)
        self.log = [] if log else None

    def set_epoch(self, epoch):
        pass

    def __len__(self):
        return self.steps

    def __iter__(self):
        for _ in range(self.steps):
            if self.cursor == self.n:
                self.order = self.rng.permutation(self.n)
                self.cursor = 0
            rows = self.order[self.cursor:self.cursor + self.batch]
            self.cursor += self.batch
            self.handed += len(rows)
            if self.log is not None:
                self.log.append(rows.copy())
            yield rows
