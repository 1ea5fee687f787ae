"""Fused ReLU + 2x2 max pool with an argmax-code backward.

Counterpart of ``hawkeye_tpu/ops/pool.py``. ``relu_maxpool2x2`` takes the
PRE-ReLU activation ``[B, H, W, C]`` (NHWC, as in the JAX package) and returns
the pooled POST-ReLU map ``[B, H/2, W/2, C]``:

* forward: the max over each 2x2 window, then ReLU (the two commute because
  ReLU is monotone), plus a ``uint8`` code 0..3 of the window position that
  won. The first max in row-major window order wins (strict ``>`` at each
  merge), like XLA's select-and-scatter.
* backward: ``dp`` goes to the recorded position, gated by ``p > 0`` (the
  ReLU derivative at the winner); every other ``dx`` is zero.

The residuals are only ``(idx, p)``: the full-resolution pre-pool tensor is
freed after the forward.

On a CUDA tensor the op runs the hand-written kernels in ``csrc/pool.cu``
(``pool_fwd``/``pool_bwd`` below), which replace the TPU's Pallas kernels
``hawkeye_tpu/ops/pallas_pool.py`` ``pool_fwd``/``pool_bwd``. On Hopper they
are bound by device-memory bytes (see the source note in ``pool.cu``); they
take every shape with even H and W, so there is no shape gate and no
fallback. On a CPU tensor they use the plain versions beside them
(``pool_fwd_plain``/``pool_bwd_plain``, ports of ``_pool_fwd_impl`` and
``_pool_bwd_lax``), which the kernels match bit for bit.
"""

from __future__ import annotations

import torch

from . import _build


def _check_even(h, w):
    if h % 2 or w % 2:
        raise ValueError(f"relu_maxpool2x2 needs even spatial dims, got {h}x{w}")


# ----------------------------------------------------------------------------
# plain versions
# ----------------------------------------------------------------------------
def pool_fwd_plain(x):
    """[B, H, W, C] -> (p [B, H/2, W/2, C], idx uint8 codes 0..3)."""
    _check_even(x.shape[1], x.shape[2])
    c00 = x[:, 0::2, 0::2, :]
    c01 = x[:, 0::2, 1::2, :]
    c10 = x[:, 1::2, 0::2, :]
    c11 = x[:, 1::2, 1::2, :]
    m0 = torch.maximum(c00, c01)
    m1 = torch.maximum(c10, c11)
    m = torch.maximum(m0, m1)
    u8 = torch.uint8
    i0 = torch.where(c01 > c00, torch.ones((), dtype=u8, device=x.device),
                     torch.zeros((), dtype=u8, device=x.device))
    i1 = torch.where(c11 > c10, torch.full((), 3, dtype=u8, device=x.device),
                     torch.full((), 2, dtype=u8, device=x.device))
    idx = torch.where(m1 > m0, i1, i0)
    p = torch.maximum(m, torch.zeros((), dtype=m.dtype, device=m.device))
    return p.contiguous(), idx.contiguous()


def _up2(a):
    """Nearest-neighbour 2x upsample of [B, H2, W2, C] -> [B, 2H2, 2W2, C]."""
    b, h2, w2, c = a.shape
    return a[:, :, None, :, None, :].expand(b, h2, 2, w2, 2, c).reshape(
        b, 2 * h2, 2 * w2, c)


def pool_bwd_plain(dp, idx, p):
    """Route ``dp`` to the recorded argmax positions, gated by ``p > 0``."""
    g = torch.where(p > 0, dp, torch.zeros((), dtype=dp.dtype, device=dp.device))
    gu = _up2(g)
    iu = _up2(idx)
    b, h, w, _ = gu.shape
    row = (torch.arange(h, device=dp.device) % 2).view(1, h, 1, 1)
    col = (torch.arange(w, device=dp.device) % 2).view(1, 1, w, 1)
    pos = (row * 2 + col).to(torch.uint8)
    return torch.where(iu == pos, gu,
                       torch.zeros((), dtype=gu.dtype, device=gu.device))


# ----------------------------------------------------------------------------
# kernel wrappers: plain version on a CPU tensor, the CUDA kernel otherwise
# ----------------------------------------------------------------------------
def pool_fwd(x):
    """Fused ReLU + 2x2/2 max pool with codes; the ``pool_fwd`` kernel."""
    if x.device.type == "cpu":
        return pool_fwd_plain(x)
    if x.dim() != 4:
        raise ValueError(f"pool_fwd takes [B, H, W, C], got {tuple(x.shape)}")
    b, h, w, c = x.shape
    _check_even(h, w)
    _build.require_cuda("pool_fwd", x)
    code = _build.dtype_code(x.dtype)
    p = torch.empty((b, h // 2, w // 2, c), dtype=x.dtype, device=x.device)
    idx = torch.empty((b, h // 2, w // 2, c), dtype=torch.uint8, device=x.device)
    rc = _build.kernel("hk_pool_fwd")(
        code, x.data_ptr(), p.data_ptr(), idx.data_ptr(), b, h, w, c,
        _build.stream_of(x))
    _build.check(rc, "pool_fwd")
    _build.LAUNCHES["pool_fwd"] += 1
    return p, idx


def pool_bwd(dp, idx, p):
    """Index-routed backward of ``pool_fwd``; the ``pool_bwd`` kernel."""
    if dp.device.type == "cpu":
        return pool_bwd_plain(dp, idx, p)
    if dp.dim() != 4 or dp.shape != idx.shape or dp.shape != p.shape:
        raise ValueError("pool_bwd: dp, idx and p must share one [B,H2,W2,C] "
                         f"shape, got {tuple(dp.shape)}, {tuple(idx.shape)}, "
                         f"{tuple(p.shape)}")
    if idx.dtype != torch.uint8 or p.dtype != dp.dtype:
        raise TypeError(f"pool_bwd: idx must be uint8 and p {dp.dtype}")
    _build.require_cuda("pool_bwd", dp, idx, p)
    code = _build.dtype_code(dp.dtype)
    b, h2, w2, c = dp.shape
    dx = torch.empty((b, 2 * h2, 2 * w2, c), dtype=dp.dtype, device=dp.device)
    rc = _build.kernel("hk_pool_bwd")(
        code, dp.data_ptr(), idx.data_ptr(), p.data_ptr(), dx.data_ptr(),
        b, h2, w2, c, _build.stream_of(dp))
    _build.check(rc, "pool_bwd")
    _build.LAUNCHES["pool_bwd"] += 1
    return dx


class _ReluMaxPool2x2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        p, idx = pool_fwd(x.contiguous())
        ctx.save_for_backward(idx, p)
        return p

    @staticmethod
    def backward(ctx, dp):
        idx, p = ctx.saved_tensors
        return pool_bwd(dp.contiguous(), idx, p)


def relu_maxpool2x2(x):
    """``max_pool(relu(x), 2x2, stride 2)`` over NHWC; takes the PRE-ReLU
    activation and returns the pooled POST-ReLU map."""
    _check_even(x.shape[1], x.shape[2])
    return _ReluMaxPool2x2.apply(x)
