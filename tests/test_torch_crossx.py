"""The port's CrossX model and loss (hawkeye_tpu_torch/models/methods/
crossx.py, losses/crossx.py) against the JAX package's on the CPU.

The model at its fixed ResNet-50 depth, 64x64, batch 2 (stage-3 parts
4x4, stage-4 parts 2x2, so the nearest resize of the fusion is 2 -> 4):
an eval forward, then one train-mode step through the CrossX loss from
the same perturbed weights (see test_torch_osme.py), trunk, excitations
and fusion in float64 (the three heads are float32 in both packages),
tolerances as test_torch_osme.py; and an eval forward of the one-part
model, which is the plain ResNet-50 with ``fc_ulti``. The loss alone: values rtol 1e-5,
gradients rtol 1e-4 / atol 1e-6, with a probability of exactly 0 in the
KL's target (its ``p > 0`` guard)."""

import torch_threads  # noqa: F401  (PyTorch's thread count: see the module)
import jax
import jax.numpy as jnp
import numpy as np
import torch

import hawkeye_tpu.models  # noqa: F401
from hawkeye_tpu.losses.crossx import CrossXLoss as JaxCrossXLoss
from hawkeye_tpu.models.methods.crossx import CrossXNet as JaxCrossXNet
from hawkeye_tpu_torch.losses.crossx import CrossXLoss
from hawkeye_tpu_torch.models.methods.crossx import CrossXNet
from test_torch_osme import compare_eval, compare_train_step, shared_variables

CRIT = {"num_parts": 2, "gamma": [0.5, 0.25, 0.5]}
KEYS = ("logits", "logits_ulti", "logits_plty", "logits_cmbn", "ulti_parts",
        "plty_parts", "cmbn_parts")


def _port(num_parts):
    pm = CrossXNet(num_classes=5, num_parts=num_parts, dtype=torch.float64)
    heads = [m for n, m in pm.named_children() if n.startswith("fc_")]
    return pm, heads


def test_crossx_train_step_matches_jax():
    x = np.random.RandomState(10).randn(2, 64, 64, 3)
    jm = JaxCrossXNet(num_classes=5, num_parts=2, dtype=jnp.float64)
    pm, heads = _port(2)
    variables = shared_variables(jm, pm, x.shape, 11)
    pm.to(torch.float64)
    for h in heads:  # the float32 heads
        h.float()
    compare_train_step(jm, pm, variables, x, JaxCrossXLoss(CRIT), CrossXLoss(CRIT),
                       {"label": np.array([1, 4])}, keys=KEYS)


def test_crossx_one_part_is_the_plain_trunk():
    x = np.random.RandomState(12).randn(2, 64, 64, 3)
    jm = JaxCrossXNet(num_classes=5, num_parts=1, dtype=jnp.float64)
    pm, heads = _port(1)
    assert [n for n, _ in pm.named_children() if not n.startswith("layer")] == [
        "conv1", "bn1", "fc_ulti"]
    variables = shared_variables(jm, pm, x.shape, 13)
    pm.to(torch.float64)
    heads[0].float()
    assert compare_eval(jm, pm, variables, x).keys() == {"logits"}
    assert CrossXLoss(dict(CRIT, num_parts=1))(
        {"logits": torch.zeros(2, 5)}, {"label": torch.tensor([0, 1])}) > 0


def test_crossx_loss_matches_jax():
    rs = np.random.RandomState(14)
    b, p, c = 4, 3, 6
    arrays = {k: rs.randn(b, c).astype(np.float32) * 3
              for k in ("logits_ulti", "logits_plty", "logits_cmbn")}
    arrays["logits_ulti"][0, 0] = -200.0  # softmax underflows to exactly 0
    for k, d in (("ulti_parts", 8), ("plty_parts", 5), ("cmbn_parts", 5)):
        arrays[k] = np.abs(rs.randn(b, p, d)).astype(np.float32)
    labels = np.array([0, 5, 2, 2])
    crit = {"num_parts": p, "gamma": [0.5, 0.25, 0.5]}
    names = sorted(arrays)

    def jax_loss(*vals):
        out = dict(zip(names, vals))
        out["logits"] = out["logits_ulti"]
        return JaxCrossXLoss(crit)(out, {"label": jnp.asarray(labels)})

    loss_j, grads_j = jax.jit(jax.value_and_grad(jax_loss, argnums=tuple(range(len(names)))))(
        *(jnp.asarray(arrays[k]) for k in names))
    ts = [torch.from_numpy(arrays[k]).requires_grad_() for k in names]
    out = dict(zip(names, ts))
    out["logits"] = out["logits_ulti"]
    loss = CrossXLoss(crit)(out, {"label": torch.from_numpy(labels)})
    loss.backward()
    assert float(torch.softmax(ts[names.index("logits_ulti")].detach(), -1)[0, 0]) == 0.0
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-5)
    for t, w, k in zip(ts, grads_j, names):
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=1e-4, atol=1e-6, err_msg=k)
