"""The port's forward-form dgrad conv (hawkeye_tpu_torch/ops/conv.py)
against the JAX package's ``conv3x3_same_fast_dgrad`` in float64: values,
``dx`` and ``dw`` within 1e-10 of their largest value, and ``dx`` and
``dw`` against autograd of the plain conv. The VGG trunk with
``fast_dgrad`` gives the plain trunk's values and gradients (VGG-16 at
32x32, float64)."""

import torch_threads  # noqa: F401  (PyTorch's thread count: see the module)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from hawkeye_tpu.ops.conv import conv3x3_same_fast_dgrad as jax_fast_dgrad
from hawkeye_tpu_torch import BACKBONE
from hawkeye_tpu_torch.models import init_parameters
from hawkeye_tpu_torch.ops.conv import conv3x3_same_fast_dgrad

TOL = 1e-10


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("cin,cout", [(5, 5), (4, 6)])
def test_fast_dgrad_matches_jax_and_autograd(cin, cout):
    rs = np.random.RandomState(cin * 10 + cout)
    x = rs.randn(2, 10, 12, cin)  # NHWC
    w = rs.randn(3, 3, cin, cout) * 0.2  # HWIO
    dy = rs.randn(2, 10, 12, cout)
    with jax.enable_x64(True):
        y_j, vjp = jax.vjp(jax_fast_dgrad, jnp.asarray(x), jnp.asarray(w))
        dx_j, dw_j = vjp(jnp.asarray(dy))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    wt = torch.from_numpy(w).permute(3, 2, 0, 1).requires_grad_()
    y = conv3x3_same_fast_dgrad(xt, wt)
    y.backward(torch.from_numpy(dy).permute(0, 3, 1, 2))
    _close(y.detach().permute(0, 2, 3, 1).numpy(), y_j)
    _close(xt.grad.permute(0, 2, 3, 1).numpy(), dx_j)
    _close(wt.grad.permute(2, 3, 1, 0).numpy(), dw_j)
    # against autograd of the plain conv
    xr = xt.detach().clone().requires_grad_()
    wr = wt.detach().clone().requires_grad_()
    F.conv2d(xr, wr, padding=1).backward(torch.from_numpy(dy).permute(0, 3, 1, 2))
    _close(xt.grad.numpy(), xr.grad.numpy())
    _close(wt.grad.numpy(), wr.grad.numpy())
    with pytest.raises(ValueError, match="3x3"):
        conv3x3_same_fast_dgrad(xt, wt[:, :, :1])


def test_vgg_fast_dgrad_equals_the_plain_trunk():
    x = torch.from_numpy(np.random.RandomState(0).randn(2, 32, 32, 3))
    out = {}
    for fast in (False, True):
        m = BACKBONE.get("vgg16")(dtype=torch.float64, fast_dgrad=fast)
        init_parameters(m, torch.Generator().manual_seed(1))
        m.double()
        y = m(x)["pooled_features"]
        (y ** 2).mean().backward()
        out[fast] = (y.detach(), {n: p.grad for n, p in m.named_parameters()})
    _close(out[True][0].numpy(), out[False][0].numpy())
    assert out[True][1].keys() == out[False][1].keys()
    for n, g in out[False][1].items():
        _close(out[True][1][n].numpy(), g.numpy())
    # the option is off under BatchNorm, as in the JAX model
    assert not BACKBONE.get("vgg16_bn")(fast_dgrad=True).fast_dgrad
