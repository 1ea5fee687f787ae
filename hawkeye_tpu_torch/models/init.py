"""Parameter initialisation from an explicit generator.

Matches the JAX package's flax defaults in distribution (not in bits):
conv and dense kernels are LeCun-normal (variance 1/fan_in, normal truncated
at two standard deviations), biases zero.
"""

from __future__ import annotations

import math

import torch
from torch import nn

# std of a unit normal truncated to [-2, 2] (flax's variance_scaling constant)
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def init_parameters(module: nn.Module, generator: torch.Generator):
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
            if m.bias is not None:
                m.bias.zero_()
    return module
