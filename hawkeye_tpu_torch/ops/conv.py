"""Stride-1 SAME 3x3 conv with a forward-form data gradient.

Counterpart of ``hawkeye_tpu/ops/conv.py``. For stride 1, SAME padding and
an odd kernel the data gradient of a conv is itself a forward conv:

    dx = conv_same(dy, W flipped in both spatial axes, in/out swapped)

(SAME zero padding of ``dy`` supplies the border terms), so the backward
computes ``dx`` that way and asks ``aten.convolution_backward`` for the
weight gradient alone. The JAX package wrote it for a TPU whose dgrad path
tiled worse than its forward convs; on the GPU both are cuDNN convs, and
``model.fast_dgrad`` selects it for the VGG trunk's 64->64 convs as the JAX
model does. Not a Pallas kernel: cuDNN computes both convs.

Layout: NCHW tensors (the trunk's channels-last memory) and an OIHW weight,
as ``F.conv2d`` takes them; the bias stays outside (the JAX op has none).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


class _FastDgradConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return F.conv2d(x, w, padding=1)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = F.conv2d(dy, w.flip(2, 3).transpose(0, 1), padding=1)
        if ctx.needs_input_grad[1]:
            dw = torch.ops.aten.convolution_backward(
                dy, x, w, None, (1, 1), (1, 1), (1, 1), False, (0, 0), 1,
                (False, True, False))[1]
        return dx, dw


def conv3x3_same_fast_dgrad(x, w):
    """``F.conv2d(x, w, padding=1)`` (NCHW ``x``, OIHW 3x3 ``w``) whose
    backward computes ``dx`` as a forward conv of ``dy``."""
    if w.shape[2:] != (3, 3):
        raise ValueError(f"conv3x3_same_fast_dgrad takes a 3x3 kernel, got "
                         f"{tuple(w.shape)}")
    return _FastDgradConv.apply(x, w)
