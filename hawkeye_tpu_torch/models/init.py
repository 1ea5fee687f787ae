"""Parameter initialisation from an explicit generator.

Matches the JAX package's flax defaults in distribution (not in bits):
conv and dense kernels are LeCun-normal (variance 1/fan_in, normal truncated
at two standard deviations), biases zero; BatchNorm scale 1, bias 0,
running mean 0 and running variance 1. A module with an
``init_own_parameters(generator)`` method sets its own after that.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .backbones.norm import BatchNorm

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
        elif isinstance(m, BatchNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
            m.running_mean.zero_()
            m.running_var.fill_(1.0)
    # then the modules' own rules: raw parameters (Interp-Parts' part
    # centres) and inits that differ from the defaults (a zero-scale bn3)
    for m in module.modules():
        if hasattr(m, "init_own_parameters"):
            m.init_own_parameters(generator)
    return module
