"""The port's CIN model and loss (hawkeye_tpu_torch/models/methods/cin.py,
losses/cin.py) against the JAX package's on the CPU.

The model: a one-block-per-stage trunk (``TINY``; the test's name is from
its resnet18 days),
in float64 at 64x64 (a 2x2 ``c5`` map: the
NHWC flatten order of ``gate_fc`` and ``pair_head`` shows; see
test_torch_osme.py), ``r_channel`` 16, batch 4 (rows 0/2 of one class,
1/3 of two), an eval forward (no ``pair_embed``), then one train-mode
step through the CIN loss from the same perturbed weights, tolerances as
test_torch_osme.py. SCI and CCI are float32 in both packages, and the one
``conv`` module serves both: its gradient is the sum of both uses.

The loss alone, with the JAX package's paper-semantics deltas (elementwise
pair labels, squared hinge, ``sqrt(d^2 + 1e-12)``, pair weight
``w[:h] * w[h:2h]``): pairs pulled, pushed inside and outside the margin,
an identical pair (finite gradient), and an odd batch; values rtol 1e-5,
gradients rtol 1e-4 / atol 1e-6."""

import torch_threads  # noqa: F401  (PyTorch's thread count: see the module)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hawkeye_tpu.models  # noqa: F401
from hawkeye_tpu.losses.cin import CINLoss as JaxCINLoss
from hawkeye_tpu.models.methods.cin import CIN as JaxCIN
from hawkeye_tpu_torch.losses.cin import CINLoss
from hawkeye_tpu_torch.models.methods.cin import CIN
from test_torch_osme import compare_eval, compare_train_step, shared_variables
from test_torch_resnet import TINY
from test_torch_resnet import tiny_trunk  # noqa: F401  (a fixture: pytestmark)

pytestmark = pytest.mark.usefixtures("tiny_trunk")


def test_cin_resnet18_train_step_and_eval_match_jax():
    x = np.random.RandomState(8).randn(4, 64, 64, 3)
    batch = {"label": np.array([1, 0, 1, 3])}
    jm = JaxCIN(num_classes=5, backbone_name=TINY, r_channel=16,
                dtype=jnp.float64)
    pm = CIN(num_classes=5, backbone_name=TINY, r_channel=16,
             image_size=64, dtype=torch.float64)
    assert pm.gate_fc.in_features == 2 * 2 * 2 * 512
    assert pm.pair_head.in_features == 2 * 2 * 512
    variables = shared_variables(jm, pm, x.shape, 9)
    pm.backbone.to(torch.float64)
    assert compare_eval(jm, pm, variables, x).keys() == {"logits"}
    crit = {"alpha": 2.0, "beta": 0.5}
    compare_train_step(jm, pm, variables, x, JaxCINLoss(crit), CINLoss(crit),
                       batch, keys=("logits", "pair_embed"))


@pytest.mark.parametrize("n,weighted", [(8, False), (8, True), (7, False)],
                         ids=["even", "weighted", "odd"])
def test_cin_loss_matches_jax(n, weighted):
    rs = np.random.RandomState(n + weighted)
    h = n // 2
    z = (rs.randn(n, 5) * 0.15).astype(np.float32)
    z[h + 1] = z[1]  # an identical pair: d = 0
    z[h + 2] = z[2] + 2.0  # a pair beyond the margin
    logits = rs.randn(n, 4).astype(np.float32)
    labels = np.array([0, 1, 2, 3, 0, 1, 3, 2])[:n]
    batch = {"label": labels}
    if weighted:
        batch["weight"] = np.array([1, 1, 1, 1, 1, 1, 1, 0], np.float32)[:n]
    crit = {"alpha": 2.0, "beta": 0.5}

    def jax_loss(a, lg):
        return JaxCINLoss(crit)({"logits": lg, "pair_embed": a},
                                {k: jnp.asarray(v) for k, v in batch.items()})

    loss_j, grads_j = jax.jit(jax.value_and_grad(jax_loss, argnums=(0, 1)))(
        jnp.asarray(z), jnp.asarray(logits))
    a, lg = (torch.from_numpy(t).requires_grad_() for t in (z, logits))
    loss = CINLoss(crit)({"logits": lg, "pair_embed": a},
                         {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-5)
    for g, w in zip((a.grad, lg.grad), grads_j):
        assert np.isfinite(g.numpy()).all()
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-6)
