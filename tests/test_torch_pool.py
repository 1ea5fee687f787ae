"""The port's relu_maxpool2x2 (hawkeye_tpu_torch/ops/pool.py) against the JAX
package: the plain versions against the Pallas kernels run in interpret mode
and against the lax argmax formulation, forward and backward, f32 and bf16,
with ties and all-negative windows. Every comparison is bit-exact: the op
only selects and routes values, it never rounds."""

import torch_threads  # noqa: F401  (PyTorch's thread count: see the module)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hawkeye_tpu.ops import pallas_pool
from hawkeye_tpu.ops import pool as jax_pool
from hawkeye_tpu_torch.ops import _build
from hawkeye_tpu_torch.ops import pool as port_pool

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(shape, seed, jdt):
    """Values on a coarse grid (many ties inside windows) with a share of
    all-negative windows, exactly representable in bf16."""
    rs = np.random.RandomState(seed)
    x = np.round(rs.randn(*shape) * 2.0) / 2.0
    b, h, w, c = shape
    neg = rs.rand(b, h // 2, 1, w // 2, 1, c) < 0.2
    x = x.reshape(b, h // 2, 2, w // 2, 2, c)
    x = np.where(neg, -np.abs(x) - 0.5, x).reshape(shape)
    return np.asarray(jnp.asarray(x, jdt).astype(jnp.float32))


def _to_jax(a, jdt):
    return jnp.asarray(a, jdt)


def _to_torch(a, tdt):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(tdt)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy() if t.dtype.is_floating_point else t.numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_plain_matches_pallas_interpret(dt):
    jdt, tdt = DTYPES[dt]
    shape = (64, 8, 8, 64)
    assert pallas_pool.supports(shape, jdt)
    x = _inputs(shape, 0, jdt)
    dp = np.asarray(jnp.asarray(
        np.random.RandomState(1).randn(64, 4, 4, 64), jdt).astype(jnp.float32))

    p_j, i_j = pallas_pool.pool_fwd(_to_jax(x, jdt))
    dx_j = pallas_pool.pool_bwd(_to_jax(dp, jdt), i_j, p_j)

    p_t, i_t = port_pool.pool_fwd_plain(_to_torch(x, tdt))
    assert i_t.dtype == torch.uint8 and p_t.dtype == tdt
    dx_t = port_pool.pool_bwd_plain(_to_torch(dp, tdt), i_t, p_t)

    np.testing.assert_array_equal(_np(p_t), _np(p_j))
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_j).astype(np.uint8))
    np.testing.assert_array_equal(_np(dx_t), _np(dx_j))


@pytest.mark.parametrize("dt", sorted(DTYPES))
def test_autograd_matches_jax_argmax_path(dt, monkeypatch):
    jdt, tdt = DTYPES[dt]
    monkeypatch.setattr(jax_pool, "FORCE_LAX", True)
    x = _inputs((3, 8, 12, 5), 2, jdt)
    dp = np.asarray(jnp.asarray(
        np.random.RandomState(3).randn(3, 4, 6, 5), jdt).astype(jnp.float32))

    p_j, vjp = jax.vjp(jax_pool.relu_maxpool2x2, _to_jax(x, jdt))
    (dx_j,) = vjp(_to_jax(dp, jdt))

    xt = _to_torch(x, tdt).requires_grad_(True)
    p_t = port_pool.relu_maxpool2x2(xt)
    p_t.backward(_to_torch(dp, tdt))

    np.testing.assert_array_equal(_np(p_t), _np(p_j))
    np.testing.assert_array_equal(_np(xt.grad), _np(dx_j))
    # and the JAX plain idx formulation gives the same codes
    _, i_ref = jax_pool._pool_fwd_impl(_to_jax(x, jdt))
    _, i_t = port_pool.pool_fwd_plain(_to_torch(x, tdt))
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_ref))


def test_tie_break_first_in_row_major_order(monkeypatch):
    monkeypatch.setattr(jax_pool, "FORCE_LAX", True)
    # windows: all four tie; top pair ties above bottom; bottom pair ties
    # and wins; right column wins
    w = np.array([[[1, 1], [1, 1]], [[2, 2], [1, 1]], [[1, 1], [3, 3]],
                  [[0, 4], [0, 4]]], np.float32)
    x = np.zeros((1, 2, 8, 1), np.float32)
    for k in range(4):
        x[0, :, 2 * k:2 * k + 2, 0] = w[k]
    _, i_t = port_pool.pool_fwd_plain(torch.from_numpy(x))
    assert i_t.flatten().tolist() == [0, 0, 2, 1]
    dp = np.arange(1, 5, dtype=np.float32).reshape(1, 1, 4, 1)
    xt = torch.from_numpy(x).requires_grad_(True)
    port_pool.relu_maxpool2x2(xt).backward(torch.from_numpy(dp))
    dx_j = jax.vjp(jax_pool.relu_maxpool2x2, jnp.asarray(x))[1](jnp.asarray(dp))[0]
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(dx_j))


def test_negative_windows_route_no_gradient():
    x = (-torch.ones((1, 4, 4, 3))).requires_grad_(True)
    p = port_pool.relu_maxpool2x2(x)
    assert float(p.detach().abs().sum()) == 0.0
    p.backward(torch.ones_like(p))
    assert float(x.grad.abs().sum()) == 0.0


def test_odd_spatial_dims_raise():
    with pytest.raises(ValueError, match="even"):
        port_pool.relu_maxpool2x2(torch.zeros((1, 5, 4, 2)))
    with pytest.raises(ValueError, match="even"):
        port_pool.pool_fwd(torch.zeros((1, 4, 3, 2)))


def test_cpu_tensor_takes_plain_version_without_launch():
    _build.reset_launches()
    x = torch.randn(2, 4, 4, 8)
    p, idx = port_pool.pool_fwd(x)
    p2, idx2 = port_pool.pool_fwd_plain(x)
    assert torch.equal(p, p2) and torch.equal(idx, idx2)
    assert torch.equal(port_pool.pool_bwd(p, idx, p),
                       port_pool.pool_bwd_plain(p, idx, p))
    assert _build.LAUNCHES["pool_fwd"] == 0 and _build.LAUNCHES["pool_bwd"] == 0

