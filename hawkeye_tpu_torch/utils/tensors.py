"""Small tensor helpers: constants on a device made once, flax's dropout.

``device_constant``:
Making a tensor on the card from host values is a copy from pageable
memory, and CUDA holds the host until the stream has drained before it
makes one. Done inside a train step, that stalls the launch queue once per
call; the device pipeline takes its constants from here instead.
"""

from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=None)
def device_constant(values: tuple, dtype: torch.dtype, device: torch.device):
    """``torch.tensor(values, dtype=dtype, device=device)``, cached; the
    caller must not write to it."""
    return torch.tensor(values, dtype=dtype, device=device)


def dropout(x, rate, generator):
    """flax's ``nn.Dropout`` in train mode: keep with probability
    ``1 - rate`` (a uniform draw below it) and scale by ``1 / (1 - rate)``;
    the mask comes from ``generator``."""
    if rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), 0.0)
