"""Small constant tensors on a device, made once.

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
