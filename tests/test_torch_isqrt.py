"""The port's covariance pooling and Newton-Schulz square root
(hawkeye_tpu_torch/ops/isqrt.py) against the JAX package's
(hawkeye_tpu/ops/isqrt.py) on the CPU, float32 on both sides: values and
input gradients within rtol 1e-4, with an atol of 1e-4 of each tensor's
largest value (float32 matmul summation order). The coupled [2B, C, C]
form equals the two-bmm form bit for bit."""

import torch_threads  # noqa: F401  (PyTorch's thread count: see the module)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hawkeye_tpu.ops import isqrt as jisqrt
from hawkeye_tpu_torch.ops import isqrt


def _close(got, want, tol=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))


def _features(seed=0, shape=(3, 5, 5, 12)):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _value_and_input_grad(jfn, tfn, x, seed=1):
    want = jfn(jnp.asarray(x))
    g = np.random.RandomState(seed).randn(*want.shape).astype(np.float32)
    want_dx = jax.grad(lambda xx: (jfn(xx) * g).sum())(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tfn(xt)
    (got * torch.from_numpy(g)).sum().backward()
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    return got.detach().numpy(), want, xt.grad.numpy(), want_dx


def test_covariance_pool_matches_jax():
    got, want, dx, want_dx = _value_and_input_grad(
        jisqrt.covariance_pool, isqrt.covariance_pool, _features())
    _close(got, want)
    _close(dx, want_dx)


def _spd(seed=2, b=3, c=12):
    cov = np.asarray(jisqrt.covariance_pool(jnp.asarray(_features(seed))))
    return (cov + 0.05 * np.eye(c, dtype=np.float32)[None]).astype(np.float32)


@pytest.mark.parametrize("coupled", [True, False], ids=["coupled", "two_bmm"])
@pytest.mark.parametrize("iters", [1, 5])
def test_newton_schulz_matches_jax(coupled, iters):
    got, want, dx, want_dx = _value_and_input_grad(
        lambda m: jisqrt.newton_schulz_sqrt(m, iters, coupled_batched=coupled),
        lambda m: isqrt.newton_schulz_sqrt(m, iters, coupled_batched=coupled),
        _spd())
    _close(got, want)
    _close(dx, want_dx)


def test_newton_schulz_approximates_sqrtm():
    m = torch.from_numpy(_spd())
    s = isqrt.newton_schulz_sqrt(m, 15)
    torch.testing.assert_close(torch.bmm(s, s), m, rtol=1e-3, atol=1e-4)


def test_coupled_form_equals_two_bmm_form():
    m = torch.from_numpy(_spd(seed=3))
    for iters in (1, 5):
        assert torch.equal(isqrt.newton_schulz_sqrt(m, iters, True),
                           isqrt.newton_schulz_sqrt(m, iters, False))


def test_trace_clamp_keeps_a_zero_matrix_finite():
    z = torch.zeros((2, 4, 4), requires_grad=True)
    out = isqrt.newton_schulz_sqrt(z, 5)
    out.sum().backward()
    assert torch.isfinite(out).all() and torch.isfinite(z.grad).all()
    np.testing.assert_array_equal(
        out.detach().numpy(),
        np.asarray(jisqrt.newton_schulz_sqrt(jnp.zeros((2, 4, 4)), 5)))


def test_triu_vec_matches_jax():
    x = np.random.RandomState(4).randn(2, 7, 7).astype(np.float32)
    got = isqrt.triu_vec(torch.from_numpy(x))
    assert got.shape == (2, 28)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jisqrt.triu_vec(x)))


def test_mpn_cov_pool_matches_jax():
    got, want, dx, want_dx = _value_and_input_grad(
        lambda f: jisqrt.mpn_cov_pool(f, 5), lambda f: isqrt.mpn_cov_pool(f, 5),
        _features(5, (2, 6, 6, 10)))
    _close(got, want)
    _close(dx, want_dx)
