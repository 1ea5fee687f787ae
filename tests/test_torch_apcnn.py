"""The port's AP-CNN model and loss (hawkeye_tpu_torch/models/methods/
apcnn.py, losses/apcnn.py) against the JAX package's on the CPU.

The model: ``stage_sizes=(1, 1, 1, 1)`` and ``fpn_dim`` 32 at 96x96 (c3
12x12, so the level-3 NMS keeps two separate 64-pixel boxes before its
slots run out), 5 classes (hidden width 256, border 0.1), batch 3. Both take the
port's init with every BatchNorm scale and every bias at random
(``test_torch_ntsnet.port_variables``). The trunk and the FPN run in
float64 on both sides; the attention convs and the heads are float32 in
both packages. One compiled JAX program gives the eval forward and one
train-mode step through ``APCNNLoss``: ``rois`` identical in both modes,
the loss rtol 1e-6, logits within 1e-5 and gradients within 1e-3 of each
tensor's largest value (float32 attention and heads; the heads' ``bn1``
and ``fc1`` biases feed a train-mode BatchNorm, so their gradients are 0
in exact arithmetic and are only held below 1e-6 of the largest
gradient), and the running statistics within 1e-5 (the heads' are
float32), with layer3,
layer4, the FPN and the heads folded twice (stage I, then stage II). The
train-mode dropblock runs on the same draws on both sides: the JAX model's
``jax.random.uniform``/``randint`` give fixed values (one image per
branch: a level-3 ROI dropped, a level-4 ROI dropped, none), and the port
takes them as ``dropblock=``. The port's own draws are checked on their
own: from the caller's generator, in range, and no draw from the global
RNG.

The loss alone: random [8, B, C] logits with and without a per-sample
weight, at the default and another label smoothing, values rtol 1e-5 and
gradients rtol 1e-4 / atol 1e-6. The anchors and their adjacency: the
port's equal to the JAX package's at 448x448.
"""

import torch_threads  # noqa: F401  (PyTorch's thread count: see the module)
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hawkeye_tpu.models  # noqa: F401
from hawkeye_tpu.losses.apcnn import APCNNLoss as JaxAPCNNLoss
from hawkeye_tpu.models.methods import apcnn as jax_apcnn
from hawkeye_tpu_torch.losses.apcnn import APCNNLoss
from hawkeye_tpu_torch.models.methods.apcnn import APCNN
from test_torch_ntsnet import assert_step_matches, jax_eval_and_train_step, port_variables

KW = dict(num_classes=5, image_size=96, stage_sizes=(1, 1, 1, 1), fpn_dim=32)
# the heads' biases before their second, train-mode BatchNorm
ZERO_GRADS = tuple(f"['{h}']['{n}']['bias']" for h in ("cls3", "cls4", "cls5", "cls_concate")
                   for n in ("bn1", "fc1"))
DRAWS = {"pro": np.array([0.1, 0.45, 0.8]), "i3": np.array([0, 3, 1]),
         "i4": np.array([2, 0, 1])}


def _fixed_random():
    """``jax`` for the JAX AP-CNN module, whose dropblock draws are DRAWS."""
    def uniform(key, shape):
        return jnp.asarray(DRAWS["pro"])

    def randint(key, shape, lo, hi):
        return jnp.asarray(DRAWS["i3"] if hi == 5 else DRAWS["i4"])

    return types.SimpleNamespace(lax=jax.lax, random=types.SimpleNamespace(
        split=jax.random.split, uniform=uniform, randint=randint))


def port():
    pm = APCNN(dtype=torch.float64, **KW)
    for name, mod in pm.named_children():  # the trunk and the FPN
        if not name.startswith(("a3", "a4", "a5", "cls")):
            mod.to(torch.float64)
    return pm


def test_apcnn_eval_and_train_step_match_jax(monkeypatch):
    monkeypatch.setattr(jax_apcnn, "jax", _fixed_random())
    jm = jax_apcnn.APCNN(dtype=jnp.float64, **KW)
    pm = port()
    x = np.random.RandomState(0).randn(3, 96, 96, 3)
    batch = {"label": np.array([1, 4, 0])}
    variables = port_variables(pm, 6)
    want = jax_eval_and_train_step(jm, variables, x, JaxAPCNNLoss(), batch,
                                   rngs={"dropout": jax.random.PRNGKey(0)})
    draws = {k: torch.from_numpy(v) for k, v in DRAWS.items()}
    ev, out = assert_step_matches(
        pm, variables, x, want, APCNNLoss(), batch, ("logits", "all_logits"), 1e-5,
        grad_tol=1e-3, zero_grads=ZERO_GRADS, stats_tol=1e-5, dropblock=draws)
    for got, ref in ((ev, want[0]), (out, want[2])):
        np.testing.assert_array_equal(got["rois"].numpy(), np.asarray(ref["rois"]))
    assert out["all_logits"].shape == (8, 3, 5)
    level3 = out["rois"][:, :5]
    assert all(len({tuple(b) for b in r.tolist()}) > 1 for r in level3)
    assert len({tuple(r[0].tolist()) for r in level3}) > 1  # the images pick differently


def test_apcnn_dropblock_draws_from_the_callers_generator():
    pm = APCNN(dtype=torch.float32, **dict(KW, image_size=64)).train()
    x = torch.randn(2, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    with pytest.raises(ValueError, match="generator"):
        pm(x)
    state = torch.random.get_rng_state()
    draws = pm.dropblock_draws(torch.Generator().manual_seed(3), 64)
    assert torch.equal(torch.random.get_rng_state(), state)
    assert ((draws["pro"] >= 0) & (draws["pro"] < 1)).all()
    assert set(draws["i3"].tolist()) == set(range(5))
    assert set(draws["i4"].tolist()) == set(range(3))
    a = pm(x, generator=torch.Generator().manual_seed(7))["logits"]
    b = pm(x, dropblock=pm.dropblock_draws(torch.Generator().manual_seed(7), 2))["logits"]
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert torch.equal(torch.random.get_rng_state(), state)


@pytest.mark.parametrize("weighted,smoothing", [(False, None), (True, 0.2)],
                         ids=["default", "weighted_0.2"])
def test_apcnn_loss_matches_jax(weighted, smoothing):
    rs = np.random.RandomState(7)
    heads = rs.randn(8, 6, 5).astype(np.float32)
    batch = {"label": rs.randint(0, 5, 6)}
    if weighted:
        batch["weight"] = np.array([1, 1, 0, 1, 1, 0], np.float32)
    cfg = None if smoothing is None else {"label_smoothing": smoothing}
    loss_j, grad_j = jax.jit(jax.value_and_grad(lambda h: JaxAPCNNLoss(cfg)(
        {"all_logits": h}, {k: jnp.asarray(v) for k, v in batch.items()})))(
        jnp.asarray(heads))
    h = torch.from_numpy(heads).requires_grad_()
    loss = APCNNLoss(cfg)({"all_logits": h}, {k: torch.from_numpy(v)
                                              for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(h.grad.numpy(), np.asarray(grad_j), rtol=1e-4, atol=1e-6)


def test_apcnn_anchors_and_adjacency_match_jax():
    pm = APCNN(num_classes=200)
    for lvl, (stride, size, _) in enumerate(((8, 64, 5), (16, 128, 3), (32, 256, 1))):
        boxes = jax_apcnn.level_anchors(size, 448 // stride, 448 // stride, stride)
        clipped = boxes.copy()
        clipped[:, 0::2] = np.clip(clipped[:, 0::2], 0, 447)
        clipped[:, 1::2] = np.clip(clipped[:, 1::2], 0, 447)
        np.testing.assert_array_equal(getattr(pm, f"anchors{lvl}").numpy(), clipped)
        np.testing.assert_array_equal(getattr(pm, f"adjacency{lvl}").numpy(),
                                      jax_apcnn.anchor_adjacency(boxes, 0.05))
    assert not any(k.startswith(("anchors", "adjacency")) for k in pm.state_dict())
