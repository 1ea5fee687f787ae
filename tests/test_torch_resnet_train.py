"""One train step of the port's Baseline ResNets against the JAX package
(hawkeye_tpu_torch/models), from the port's init carried to JAX by the
bridge (``port_init``): logits rtol 1e-4 / atol 1e-5; parameter gradients rtol 1e-3 with an
atol of 1e-3 of each tensor's largest gradient (conv summation order differs
between XLA and PyTorch on the CPU); the mutated running statistics rtol
1e-5 with an atol of 1e-5 of each tensor's largest value (a batch mean near
zero is a difference of float32 sums of larger terms).

ResNet-18 runs in float32. ResNet-50 and ResNeXt-50 run in float64 on both
sides: in a train-mode step at 64x64 the batch statistics of fifty layers
amplify float32 rounding to ~1e-4 of the logits, and several pre-ReLU values
lie within float32 rounding of zero, each of which, landing on the other
side, changes one channel's gradient by O(1). Two correct float32
implementations (or one against its own float64 run) disagree there."""

import torch_threads  # noqa: F401  (PyTorch's thread count: see the module)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hawkeye_tpu.models  # noqa: F401
import hawkeye_tpu_torch.models  # noqa: F401
from hawkeye_tpu.models.methods.baseline import BaselineClassifier as JaxBaseline
from hawkeye_tpu_torch.models import export_jax_variables, load_jax_variables
from hawkeye_tpu_torch.models.methods.baseline import BaselineClassifier
from test_torch_resnet import _assert_close_scaled, _port_grads, _with_stats, port_init


@pytest.mark.parametrize("name,dtype", [("resnet18", "float32"),
                                        ("resnet50", "float64"),
                                        ("resnext50_32x4d", "float64")])
def test_train_step_matches_jax(name, dtype):
    """One cross-entropy train step from non-trivial running statistics:
    logits, every parameter's gradient, and the batch statistics flax
    mutates (biased variance, momentum 0.9)."""
    x = np.random.RandomState(0).randn(2, 64, 64, 3)
    y = np.array([1, 3])
    f64 = dtype == "float64"
    pm = BaselineClassifier(name, 5, dtype=getattr(torch, dtype))
    pm.backbone.to(getattr(torch, dtype))  # the float32 head reads a float32 pool
    variables = _with_stats(port_init(pm, 1), 2)
    with jax.enable_x64(f64):
        jm = JaxBaseline(backbone_name=name, num_classes=5,
                         dtype=jnp.float64 if f64 else jnp.float32)

        def loss_fn(p):
            out, mut = jm.apply({"params": p,
                                 "batch_stats": variables["batch_stats"]},
                                jnp.asarray(x, dtype), train=True,
                                mutable=["batch_stats"])
            loss = -jax.nn.log_softmax(out["logits"])[jnp.arange(2), y].mean()
            return loss, (out["logits"], mut["batch_stats"])

        (_, (logits_j, stats_j)), g_j = jax.device_get(jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(variables["params"]))

    load_jax_variables(pm, variables)
    pm.train()
    logits = pm(torch.from_numpy(x).to(getattr(torch, dtype)))["logits"]
    torch.nn.functional.cross_entropy(logits, torch.from_numpy(y)).backward()

    np.testing.assert_allclose(logits.detach().numpy(), logits_j,
                               rtol=1e-4, atol=1e-5)
    _assert_close_scaled(_port_grads(pm), g_j, rtol=1e-3, scale_tol=1e-3)
    _assert_close_scaled(export_jax_variables(pm)["batch_stats"], stats_j,
                         rtol=1e-5, scale_tol=1e-5)
