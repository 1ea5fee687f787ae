"""The port's MPN (hawkeye_tpu_torch/models/methods/mpn.py) against the
JAX package's on the CPU: one train-mode step (batch statistics, ``dr_bn``
folded into its running statistics) from the port's init carried to JAX
by the bridge (``port_init``), a one-block-per-stage trunk (``TINY``; the test's name is from
its resnet18 days) with
``dimension_reduction`` 16, also with ``is_sqrt``/``is_vec`` off and with
the two-bmm iteration. The input is 96x96, a 3x3 ``c5`` map.

The trunk runs in float64 on both sides; the head is float32 in both
packages whatever the trunk's dtype. In float32 the square root of a
covariance over nine positions, after train-mode batch statistics,
amplifies the trunk's rounding to ~1e-3 of a deep BatchNorm's gradient in
either package alone. Logits rtol 1e-4 / atol 1e-5 of their largest value;
gradients rtol 1e-3 with an atol of 1e-3 of each tensor's largest;
running statistics rtol 1e-5 with an atol of 1e-5 of the largest."""

import torch_threads  # noqa: F401  (PyTorch's thread count: see the module)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hawkeye_tpu.models  # noqa: F401
import hawkeye_tpu_torch.models  # noqa: F401
from hawkeye_tpu.models.methods.mpn import MPN as JaxMPN
from hawkeye_tpu_torch.models import export_jax_variables, load_jax_variables
from hawkeye_tpu_torch.models.methods.mpn import MPN
from test_torch_highorder_methods import ce
from test_torch_resnet import TINY, _assert_close_scaled, _port_grads, _with_stats, port_init
from test_torch_resnet import tiny_trunk  # noqa: F401  (a fixture: pytestmark)

pytestmark = pytest.mark.usefixtures("tiny_trunk")


def mpn_step(name, **kw):
    dtype, f64 = "float64", True
    x = np.random.RandomState(1).randn(2, 96, 96, 3)
    y = np.array([1, 3])
    pm = MPN(num_classes=5, backbone_name=name, dtype=getattr(torch, dtype), **kw)
    if f64:  # the float32 head reads the float32 covariance
        pm.backbone.to(torch.float64)
        pm.dr_bn.to(torch.float64)
    variables = _with_stats(port_init(pm, 2), 3)
    with jax.enable_x64(f64):
        jm = JaxMPN(num_classes=5, backbone_name=name,
                    dtype=jnp.float64 if f64 else jnp.float32, **kw)

        def loss_fn(p):
            out, mut = jm.apply({"params": p, "batch_stats": variables["batch_stats"]},
                                jnp.asarray(x, dtype), train=True,
                                mutable=["batch_stats"])
            return ce(out["logits"], y), (out["logits"], mut["batch_stats"])

        (_, (logits_j, stats_j)), g_j = jax.device_get(jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(variables["params"]))
    load_jax_variables(pm, variables)
    pm.train()
    logits = pm(torch.from_numpy(x).to(getattr(torch, dtype)))["logits"]
    torch.nn.functional.cross_entropy(logits, torch.from_numpy(y)).backward()
    np.testing.assert_allclose(logits.detach().numpy(), logits_j, rtol=1e-4,
                               atol=1e-5 * np.abs(logits_j).max())
    _assert_close_scaled(_port_grads(pm), g_j, rtol=1e-3, scale_tol=1e-3)
    _assert_close_scaled(export_jax_variables(pm)["batch_stats"], stats_j,
                         rtol=1e-5, scale_tol=1e-5)
    return pm


@pytest.mark.parametrize("kw", [{}, {"is_sqrt": False, "is_vec": False},
                                {"coupled_newton_schulz": False, "iter_num": 3}],
                         ids=["default", "no_sqrt_no_vec", "two_bmm_3_iters"])
def test_mpn_resnet18_train_step_matches_jax(kw):
    pm = mpn_step(TINY, dimension_reduction=16, **kw)
    dim = 16 * 17 // 2 if kw.get("is_vec", True) else 16 * 16
    assert pm.fc.in_features == dim
    assert pm.dr_conv.weight.shape == (16, 512, 1, 1)
