"""The port's bilinear pooling (hawkeye_tpu_torch/ops/bilinear.py and
ops/fused_bilinear.py) against the JAX package: the Pallas Gram kernel run in
interpret mode at C=256 and at the C=512 tiled path, the fused descriptor and
its custom backward. Tolerances are float32 summation order only: forward
rtol 1e-5 / atol 1e-6, backward rtol 1e-4."""

import torch_threads  # noqa: F401  (PyTorch's thread count: see the module)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hawkeye_tpu.ops import bilinear as jax_bilinear
from hawkeye_tpu.ops import pallas_bilinear as jax_fused
from hawkeye_tpu_torch.ops import _build
from hawkeye_tpu_torch.ops import bilinear as port_bilinear
from hawkeye_tpu_torch.ops import fused_bilinear as port_fused


def _x(shape, seed):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


@pytest.mark.parametrize("b,hw,c", [(2, 16, 256), (1, 4, 512)],
                         ids=["c256", "c512_tiled"])
def test_gram_signed_sqrt_matches_pallas_interpret(b, hw, c):
    x = _x((b, hw, c), c)
    want = np.asarray(jax_fused.gram_signed_sqrt(jnp.asarray(x)))
    _build.reset_launches()
    got = port_fused.gram_signed_sqrt(torch.from_numpy(x)).numpy()
    plain = port_fused.gram_signed_sqrt_plain(torch.from_numpy(x)).numpy()
    assert _build.LAUNCHES["gram_signed_sqrt"] == 0  # CPU: plain version
    np.testing.assert_array_equal(got, plain)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_bilinear_pool_plain_and_fused_match_jax():
    x = _x((2, 4, 4, 256), 0)
    want = np.asarray(jax_bilinear.bilinear_pool(jnp.asarray(x)))
    want_fused = np.asarray(jax_fused.bilinear_pool_fused(jnp.asarray(x)))
    got = port_bilinear.bilinear_pool(torch.from_numpy(x)).numpy()
    got_fused = port_fused.bilinear_pool_fused(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got_fused, want_fused, rtol=1e-5, atol=1e-6)


def test_fused_backward_matches_jax_custom_vjp():
    x = _x((2, 3, 3, 256), 2)

    def f_jax(x):
        return (jax_fused.bilinear_pool_fused(x) ** 2).sum()

    want = np.asarray(jax.grad(f_jax)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    (port_fused.bilinear_pool_fused(xt) ** 2).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-4, atol=1e-6)


def test_fused_backward_matches_autograd_of_plain():
    x = _x((2, 3, 3, 256), 3)
    xa = torch.from_numpy(x).requires_grad_(True)
    xb = torch.from_numpy(x).requires_grad_(True)
    (port_fused.bilinear_pool_fused(xa) ** 2).sum().backward()
    (port_bilinear.bilinear_pool(xb) ** 2).sum().backward()
    np.testing.assert_allclose(xa.grad.numpy(), xb.grad.numpy(), rtol=1e-4,
                               atol=1e-6)

