"""Fused bilinear pooling: Gram matrix with the signed-sqrt epilogue in the
kernel.

Counterpart of ``hawkeye_tpu/ops/pallas_bilinear.py`` (renamed: there is no
Pallas here). ``gram_signed_sqrt(x)`` computes, per image,
``sign(g)*sqrt(|g|+eps)`` with ``g = X^T X / HW`` over X in [HW, C]:

* forward: on a CUDA tensor, the hand-written kernels in ``csrc/gram.cu``,
  which replace the TPU kernel ``pallas_bilinear.gram_signed_sqrt``; the raw
  Gram never reaches device memory. On Hopper the float32 output store
  bounds it (84% of the bytes at the BCNN shape). For bfloat16, the main
  path, a persistent kernel loads x by TMA into a ring of swizzled
  shared-memory stages (a producer warp runs ahead across tiles), multiplies
  on the tensor cores (``wgmma``, both operands MN-major, float32
  accumulators), and writes each output tile by TMA stores that drain while
  the next tile is computed. TMA needs ``C % 8 == 0``; otherwise this
  raises. float32 input, which only the float32 card-vs-CPU reference uses,
  keeps a plain FMA kernel: TF32 tensor cores would break that reference's
  1e-4 tolerance. The Gram's symmetry is left out: it saves none of the
  store. See the source note in ``gram.cu``. On a CPU tensor the plain
  version ``gram_signed_sqrt_plain`` beside it.
* backward: ``_gram_bwd``, the same two batched products as the JAX
  package's custom VJP (which also leaves them to the compiler's matmuls):
  ``dg = dy / (2 max(|y|, sqrt(eps)))``, ``dX = X (dg + dg^T) / HW``.

``bilinear_pool_fused`` equals ``ops.bilinear.bilinear_pool``; its global L2
normalisation needs a reduction over all C^2 values, so it stays a plain pass.
"""

from __future__ import annotations

import math

import torch

from . import _build
from .bilinear import gram, l2_rows, ssqrt


def gram_signed_sqrt_plain(x, eps=1e-5):
    """[B, HW, C] -> [B, C, C] float32, plain PyTorch."""
    return ssqrt(gram(x), eps)


def gram_signed_sqrt_forward(x, eps=1e-5):
    """The ``gram_signed_sqrt`` kernel (plain version on a CPU tensor)."""
    if x.device.type == "cpu":
        return gram_signed_sqrt_plain(x, eps)
    if x.dim() != 3:
        raise ValueError(f"gram_signed_sqrt takes [B, HW, C], got {tuple(x.shape)}")
    _build.require_cuda("gram_signed_sqrt", x)
    code = _build.dtype_code(x.dtype)
    b, hw, c = x.shape
    if x.dtype == torch.bfloat16 and (c % 8 or x.data_ptr() % 16):
        raise ValueError(
            "gram_signed_sqrt: the bfloat16 kernel loads x by TMA, whose row "
            "pitch (C * 2 bytes) must be a multiple of 16 bytes and whose base "
            f"must be 16-byte aligned; got C={c}, address {x.data_ptr():#x}")
    out = torch.empty((b, c, c), dtype=torch.float32, device=x.device)
    rc = _build.kernel("hk_gram_signed_sqrt")(
        code, x.data_ptr(), out.data_ptr(), b, hw, c, float(eps),
        _build.stream_of(x))
    _build.check(rc, "gram_signed_sqrt")
    _build.LAUNCHES["gram_signed_sqrt"] += 1
    return out


def _gram_bwd(x, y, dy, eps):
    hw = x.shape[1]
    dg = dy / (2.0 * torch.clamp_min(torch.abs(y), math.sqrt(eps)))
    sym = dg + dg.transpose(1, 2)
    return (torch.bmm(x.float(), sym) / float(hw)).to(x.dtype)


class _GramSignedSqrt(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, eps):
        y = gram_signed_sqrt_forward(x.contiguous(), eps)
        ctx.save_for_backward(x, y)
        ctx.eps = eps
        return y

    @staticmethod
    def backward(ctx, dy):
        x, y = ctx.saved_tensors
        return _gram_bwd(x, y, dy, ctx.eps), None


def gram_signed_sqrt(x, eps=1e-5):
    """[B, HW, C] -> [B, C, C] = signed_sqrt(X^T X / HW), differentiable."""
    return _GramSignedSqrt.apply(x, eps)


def bilinear_pool_fused(features, *, eps=1e-5, l2_normalize=True):
    """Fused version of ``ops.bilinear.bilinear_pool``:
    [B, H, W, C] -> [B, C*C] float32."""
    b, h, w, c = features.shape
    v = gram_signed_sqrt(features.reshape(b, h * w, c), eps).reshape(b, c * c)
    if l2_normalize:
        v = l2_rows(v)
    return v
