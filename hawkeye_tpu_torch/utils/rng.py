"""Deterministic seeding and device selection.

Reference: ``utils/utils.py:102-108`` seeds python/numpy/torch. Host-side
shuffling and augmentation read ``random``/``numpy``; device randomness
(parameter init) draws from an explicit ``torch.Generator``, which
``set_random_seed`` returns where the JAX package returned a PRNG key.
"""

from __future__ import annotations

import random

import numpy as np
import torch


def set_random_seed(seed: int) -> torch.Generator:
    """Seed python/numpy/torch and return a CPU ``torch.Generator``."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    gen = torch.Generator()
    gen.manual_seed(seed)
    return gen


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA. Asking for CUDA where there is none raises: the
    port never carries on on the CPU unless the caller asked for it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was asked for (the default) but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU")
    return dev
