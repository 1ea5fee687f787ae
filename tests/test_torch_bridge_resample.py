"""The weight bridge with raw parameters, and the port's ``resize_nearest``
against the JAX package's, on the CPU.

A raw ``nn.Parameter`` called ``weight`` (Interp-Parts' part centres,
flax's ``grouping/weight`` [K, C]) keeps its flax name and layout; only
the weights of ``nn.Conv2d``/``nn.Linear`` are ``kernel`` and change
layout. ``resize_nearest`` is checked exactly (it is a gather) at integer
ratios both ways, at non-integer ones, and at sizes where JAX's float32
index arithmetic and float64 disagree (2 -> 82, 3 -> 123)."""

import torch_threads  # noqa: F401  (PyTorch's thread count: see the module)
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from hawkeye_tpu.ops.resample import resize_nearest as jax_resize_nearest
from hawkeye_tpu_torch.models import export_jax_variables, load_jax_variables
from hawkeye_tpu_torch.ops.resample import nearest_index, resize_nearest


class _Grouping(nn.Module):
    def __init__(self, k, c):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(k, c))
        self.smooth_factor = nn.Parameter(torch.zeros(k))


class _RawAndDense(nn.Module):
    def __init__(self):
        super().__init__()
        self.grouping = _Grouping(3, 5)
        self.fc = nn.Linear(5, 3)
        self.conv = nn.Conv2d(2, 4, 3)


def test_raw_weight_keeps_its_flax_name_and_layout():
    rs = np.random.RandomState(0)
    variables = {"params": {
        "grouping": {"weight": rs.randn(3, 5).astype(np.float32),
                     "smooth_factor": rs.randn(3).astype(np.float32)},
        "fc": {"kernel": rs.randn(5, 3).astype(np.float32),
               "bias": rs.randn(3).astype(np.float32)},
        "conv": {"kernel": rs.randn(3, 3, 2, 4).astype(np.float32),
                 "bias": rs.randn(4).astype(np.float32)}}}
    m = load_jax_variables(_RawAndDense(), variables)
    p = variables["params"]
    np.testing.assert_array_equal(m.grouping.weight.detach().numpy(),
                                  p["grouping"]["weight"])  # not transposed
    np.testing.assert_array_equal(m.fc.weight.detach().numpy(), p["fc"]["kernel"].T)
    np.testing.assert_array_equal(m.conv.weight.detach().numpy(),
                                  p["conv"]["kernel"].transpose(3, 2, 0, 1))
    out = export_jax_variables(m)
    assert out.keys() == {"params"}
    for mod, leaves in p.items():
        assert out["params"][mod].keys() == leaves.keys()
        for leaf, arr in leaves.items():
            np.testing.assert_array_equal(out["params"][mod][leaf], arr)


def test_bridge_refuses_a_kernel_for_a_raw_weight():
    variables = {"params": {"grouping": {"kernel": np.zeros((5, 3), np.float32),
                                         "smooth_factor": np.zeros(3, np.float32)}}}
    m = nn.Module()
    m.grouping = _Grouping(3, 5)
    with pytest.raises(KeyError, match="grouping/kernel"):
        load_jax_variables(m, variables)


@pytest.mark.parametrize("hw,out", [((14, 14), (28, 28)), ((7, 7), (14, 14)),
                                    ((28, 28), (14, 14)), ((7, 5), (12, 3)),
                                    ((5, 12), (3, 7)), ((2, 3), (82, 123)),
                                    ((13, 9), (13, 9))])
def test_resize_nearest_matches_jax(hw, out):
    x = np.random.RandomState(1).randn(2, *hw, 3).astype(np.float32)
    want = np.asarray(jax_resize_nearest(jnp.asarray(x), *out))
    got = resize_nearest(torch.from_numpy(x), *out).numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_nearest_index_is_jax_float32_arithmetic():
    for n_in, n_out in [(2, 82), (3, 123), (4, 94), (6, 9), (7, 12), (5, 3),
                        (13, 200), (28, 14)]:
        iy = np.asarray(jnp.floor(jnp.arange(n_out) * (n_in / n_out)).astype(
            jnp.int32))
        np.testing.assert_array_equal(nearest_index(n_in, n_out), iy)
    # float64 arithmetic would pick another row here
    assert (np.floor(np.arange(82) * (2 / 82)) != nearest_index(2, 82)).any()


def test_resize_nearest_gradient_is_the_scatter_of_the_gather():
    x = torch.randn(1, 3, 2, 4, requires_grad=True, dtype=torch.float64)
    y = resize_nearest(x, 7, 5)
    g = torch.randn_like(y)
    (y * g).sum().backward()
    iy, ix = nearest_index(3, 7), nearest_index(2, 5)
    want = np.zeros((1, 3, 2, 4))
    for a, r in enumerate(iy):
        for b, c in enumerate(ix):
            want[0, r, c] += g[0, a, b].numpy()
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=1e-12)
