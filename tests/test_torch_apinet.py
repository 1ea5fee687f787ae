"""The port's API-Net model and loss (hawkeye_tpu_torch/models/methods/
apinet.py, losses/apinet.py) against the JAX package's on the CPU.

The model: a one-block-per-stage trunk (``TINY``; the test's name is from
its resnet18 days),
in float64 at 64x64 (see test_torch_osme.py),
batch 6 as three classes x two samples with one padded row (weight 0), an
eval forward, then one train-mode step through the API-Net loss from the
same perturbed weights; the pair mining, the gates and the four logit
sets, tolerances as test_torch_osme.py. Dropout is off (rate 0) on both
sides for that comparison: flax and the port draw their masks from
different generators. The port's dropout is checked on its own: its mask
is ``u < 1 - rate`` of a uniform draw from the caller's generator, as
flax's ``bernoulli`` is, each of the five sites draws its own mask, and no
draw touches the global RNG.

``mine_pairs`` alone: the same indices as JAX on random embeddings with
repeated labels, a class of one (its intra search falls back to 0) and
padded rows. The loss alone: values rtol 1e-5, gradients rtol 1e-4 / atol
1e-6, with and without ``pair_weight``."""

import torch_threads  # noqa: F401  (PyTorch's thread count: see the module)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hawkeye_tpu.models  # noqa: F401
from hawkeye_tpu.losses.apinet import APINetLoss as JaxAPINetLoss
from hawkeye_tpu.models.methods.apinet import APINet as JaxAPINet
from hawkeye_tpu.models.methods.apinet import mine_pairs as jax_mine_pairs
from hawkeye_tpu_torch.losses.apinet import APINetLoss
from hawkeye_tpu_torch.models.methods import apinet
from hawkeye_tpu_torch.models.methods.apinet import APINet, mine_pairs
from test_torch_osme import compare_eval, compare_train_step, shared_variables
from test_torch_resnet import TINY
from test_torch_resnet import tiny_trunk  # noqa: F401  (a fixture: pytestmark)

pytestmark = pytest.mark.usefixtures("tiny_trunk")


def test_apinet_resnet18_train_step_and_eval_match_jax():
    x = np.random.RandomState(4).randn(6, 64, 64, 3)
    labels = np.array([2, 2, 0, 0, 4, 4])
    weight = np.array([1, 1, 1, 1, 1, 0], np.float32)
    jm = JaxAPINet(num_classes=5, backbone_name=TINY, feature_dim=512,
                   dropout_rate=0.0, dtype=jnp.float64)
    pm = APINet(num_classes=5, backbone_name=TINY, dropout_rate=0.0,
                dtype=torch.float64)
    variables = shared_variables(jm, pm, x.shape, 5,
                                 labels=jnp.zeros((6,), jnp.int32))
    pm.backbone.to(torch.float64)
    compare_eval(jm, pm, variables, x)
    batch = {"label": labels, "weight": weight}
    out = compare_train_step(
        jm, pm, variables, x, JaxAPINetLoss(), APINetLoss(), batch,
        keys=("logits", "self_logits", "other_logits", "pair_labels", "pair_weight"),
        jax_kw={"labels": jnp.asarray(labels), "weight": jnp.asarray(weight)},
        port_kw={"labels": torch.from_numpy(labels), "weight": torch.from_numpy(weight)})
    assert out["self_logits"].shape == (24, 5)
    with torch.no_grad():
        assert pm.eval()(torch.zeros(2, 64, 64, 3, dtype=torch.float64),
                         labels=torch.tensor([0, 1])).keys() == {"logits"}


def test_mine_pairs_matches_jax():
    rs = np.random.RandomState(5)
    emb = rs.randn(12, 8).astype(np.float32)
    labels = np.array([0, 0, 1, 1, 1, 2, 3, 3, 0, 4, 4, 4])  # class 2 alone
    valid = np.ones(12, bool)
    valid[[4, 11]] = False
    for v in (None, valid):
        want = jax_mine_pairs(jnp.asarray(emb), jnp.asarray(labels),
                              None if v is None else jnp.asarray(v))
        got = mine_pairs(torch.from_numpy(emb), torch.from_numpy(labels),
                         None if v is None else torch.from_numpy(v))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[0][5]) == 0  # no other sample of class 2: index 0


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "pair_weight"])
def test_apinet_loss_matches_jax(weighted):
    rs = np.random.RandomState(6)
    s, o = (rs.randn(8, 6).astype(np.float32) for _ in range(2))
    labels = rs.randint(0, 6, 8)
    pw = np.array([1, 1, 1, 0, 1, 1, 1, 0], np.float32)

    def outputs(mod, a, b):
        out = {"self_logits": a, "other_logits": b,
               "pair_labels": mod.asarray(labels) if mod is jnp else torch.from_numpy(labels)}
        if weighted:
            out["pair_weight"] = jnp.asarray(pw) if mod is jnp else torch.from_numpy(pw)
        return out

    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda a, b: JaxAPINetLoss()(outputs(jnp, a, b), {}), argnums=(0, 1)))(
        jnp.asarray(s), jnp.asarray(o))
    a, b = (torch.from_numpy(t).requires_grad_() for t in (s, o))
    loss = APINetLoss()(outputs(torch, a, b), {})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-5)
    for g, w in zip((a.grad, b.grad), grads_j):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-6)


def test_dropout_draws_flax_masks_from_the_callers_generator(monkeypatch):
    x = torch.randn(64, 32, generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(7)
    state = torch.random.get_rng_state()
    y = apinet.dropout(x, 0.5, gen)
    u = torch.rand(x.shape, generator=torch.Generator().manual_seed(7))
    torch.testing.assert_close(y, torch.where(u < 0.5, x / 0.5, 0.0), rtol=0, atol=0)
    assert torch.equal(torch.random.get_rng_state(), state)

    masks = []
    real = apinet.dropout

    def record(t, rate, generator):
        out = real(t, rate, generator)
        masks.append((out != 0).clone())
        return out

    monkeypatch.setattr(apinet, "dropout", record)
    pm = APINet(num_classes=5, backbone_name="resnet18").train()
    labels = torch.tensor([0, 0, 1, 1])
    img = torch.randn(4, 32, 32, 3)
    with pytest.raises(ValueError, match="generator"):
        pm(img, labels=labels)
    masks.clear()
    state = torch.random.get_rng_state()
    pm(img, labels=labels, generator=gen)
    assert len(masks) == 5
    assert len({m.flatten()[:64].numpy().tobytes() for m in masks}) == 5
    assert torch.equal(torch.random.get_rng_state(), state)
