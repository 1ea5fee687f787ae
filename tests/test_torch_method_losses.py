"""The port's method losses (hawkeye_tpu_torch/losses) against the JAX
package's on the CPU, float32.

PeerLearningLoss at every agreement count 0..B (B = 16) and at every value
of a T_k = 10 ramp to 0.25, with constructed loss ties and with weights
that hold zeros: the samples each peer keeps must be the JAX step's exactly
(read on the JAX side as the rows of nonzero gradient), and the losses
within rtol 1e-6. PairwiseConfusionLoss with odd and even B, with and
without weights: value and logits gradient within rtol 1e-6 (atol 1e-7 on
the gradient), on distinct rows; at a pair of equal rows the port's
gradient is finite (the JAX one is NaN there). entropic_confusion within
rtol 1e-6."""

import torch_threads  # noqa: F401  (PyTorch's thread count: see the module)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hawkeye_tpu.losses import pair_confusion as jpc
from hawkeye_tpu.losses import peer_learning as jpl
from hawkeye_tpu_torch.config import ConfigNode
from hawkeye_tpu_torch.losses import build_criterion
from hawkeye_tpu_torch.losses import pair_confusion, peer_learning

B, NC = 16, 5
RAMP = np.linspace(0.0, 0.25, 10).astype(np.float32)  # PLTrainer's T_k = 10


def _peer_batch(n_agree, seed, ties=True):
    """Logits of two peers that agree on exactly ``n_agree`` samples."""
    rs = np.random.RandomState(seed)
    agree = rs.permutation(B) < n_agree
    l1 = rs.randn(B, NC).astype(np.float32)
    l2 = rs.randn(B, NC).astype(np.float32)
    labels = rs.randint(0, NC, B)
    pred1 = l1.argmax(-1)
    target2 = np.where(agree, pred1, (pred1 + 1) % NC)
    l2[np.arange(B), target2] += 6.0
    if ties:  # equal rows with equal labels: equal losses on both peers
        for i in range(0, B - 1, 3):
            if agree[i] == agree[i + 1]:
                l1[i + 1], l2[i + 1], labels[i + 1] = l1[i], l2[i], labels[i]
    assert ((l1.argmax(-1) == l2.argmax(-1)) == agree).all()
    return l1, l2, labels


@jax.jit
def _jax_peer(l1, l2, labels, drop_rate, weight):
    def loss1(a):
        return jpl.peer_learning_losses(a, l2, labels, drop_rate, weight)[0]

    def loss2(b):
        return jpl.peer_learning_losses(l1, b, labels, drop_rate, weight)[1]

    (v1, g1), (v2, g2) = (jax.value_and_grad(loss1)(l1),
                          jax.value_and_grad(loss2)(l2))
    return v1, v2, jnp.any(g1 != 0, -1), jnp.any(g2 != 0, -1)


@pytest.mark.parametrize("weighted", [False, True], ids=["no_weight", "zero_weights"])
def test_peer_learning_matches_jax_at_every_count_and_ramp_value(weighted):
    weight = np.ones(B, np.float32)
    if weighted:
        weight[[2, 7, 11]] = 0.0
    n_hazard = 0
    for n_agree in range(B + 1):
        l1, l2, labels = _peer_batch(n_agree, seed=n_agree)
        t1, t2, tl = (torch.from_numpy(a) for a in (l1, l2, labels))
        tw = torch.from_numpy(weight) if weighted else None
        for drop_rate in RAMP:
            # python float, as PLTrainer.prepare_batch puts it in the batch
            dr = float(drop_rate)
            v1, v2, k1, k2 = jax.device_get(_jax_peer(
                l1, l2, labels, dr, weight if weighted else None))
            p1, p2, _, _ = peer_learning.peer_keep_masks(t1, t2, tl, dr, tw)
            np.testing.assert_array_equal(p1.numpy(), k1, err_msg=f"{n_agree} {dr}")
            np.testing.assert_array_equal(p2.numpy(), k2, err_msg=f"{n_agree} {dr}")
            got = peer_learning.peer_learning_losses(t1, t2, tl, dr, tw)
            np.testing.assert_allclose([float(got[0]), float(got[1])], [v1, v2],
                                       rtol=1e-6)
            n_valid = int((weight > 0)[l1.argmax(-1) == l2.argmax(-1)].sum())
            keep = (1 - drop_rate) * np.float32(n_valid)
            n_hazard += np.floor(keep) != np.floor((1 - dr) * n_valid)
    assert n_hazard > 0  # float32 and float64 keep counts differ somewhere


def test_peer_learning_criterion_reads_drop_rate_from_the_batch():
    l1, l2, labels = _peer_batch(10, seed=3, ties=False)
    crit = build_criterion(ConfigNode({"name": "PeerLearningLoss"}))
    out = {"logits1": torch.from_numpy(l1), "logits2": torch.from_numpy(l2)}
    for dr in (None, 0.25):
        batch = {"label": torch.from_numpy(labels)}
        if dr is not None:
            batch["drop_rate"] = dr
        want = jpl.PeerLearningLoss()({k: jnp.asarray(v.numpy()) for k, v in out.items()},
                                      {k: (jnp.asarray(v.numpy()) if torch.is_tensor(v) else v)
                                       for k, v in batch.items()})
        np.testing.assert_allclose(float(crit(out, batch)), float(want), rtol=1e-6)


def _pc_case(b, weighted, seed):
    rs = np.random.RandomState(seed)
    logits = rs.randn(b, NC).astype(np.float32)
    labels = rs.randint(0, NC, b)
    labels[0] = labels[b // 2]  # one pair with equal labels
    weight = None
    if weighted:
        weight = np.ones(b, np.float32)
        weight[1] = 0.0
    return logits, labels, weight


@pytest.mark.parametrize("b", [7, 8])
@pytest.mark.parametrize("weighted", [False, True], ids=["no_weight", "weights"])
def test_pairwise_confusion_matches_jax(b, weighted):
    logits, labels, weight = _pc_case(b, weighted, seed=b)
    cfg = {"name": "PairwiseConfusionLoss", "lambda_a": 0.1}
    jloss = jpc.PairwiseConfusionLoss(cfg)

    def jfn(lg):
        batch = {"label": jnp.asarray(labels)}
        if weighted:
            batch["weight"] = jnp.asarray(weight)
        return jloss({"logits": lg}, batch)

    want, want_g = jax.value_and_grad(jfn)(jnp.asarray(logits))
    crit = build_criterion(ConfigNode(cfg))
    assert isinstance(crit, pair_confusion.PairwiseConfusionLoss)
    assert crit.lambda_a == 0.1
    lt = torch.from_numpy(logits).requires_grad_(True)
    batch = {"label": torch.from_numpy(labels)}
    if weighted:
        batch["weight"] = torch.from_numpy(weight)
    got = crit({"logits": lt}, batch)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(want_g), rtol=1e-6,
                               atol=1e-7)


def test_pairwise_confusion_default_lambda_matches_jax():
    assert (pair_confusion.PairwiseConfusionLoss().lambda_a
            == jpc.PairwiseConfusionLoss().lambda_a == 10.0)


def test_pairwise_confusion_gradient_is_finite_at_a_zero_distance():
    logits, labels, _ = _pc_case(8, False, seed=1)
    logits[4] = logits[0]  # pair (0, 4): equal rows ...
    labels[4] = (labels[0] + 1) % NC  # ... with different labels
    lt = torch.from_numpy(logits).requires_grad_(True)
    loss = pair_confusion.PairwiseConfusionLoss({"lambda_a": 10.0})(
        {"logits": lt}, {"label": torch.from_numpy(labels)})
    loss.backward()
    assert torch.isfinite(loss) and torch.isfinite(lt.grad).all()
    # the equal pair's distance contributes no gradient: CE's alone is left
    ce_only = lt.detach().clone().requires_grad_(True)
    from hawkeye_tpu_torch.losses import cross_entropy

    cross_entropy(ce_only, torch.from_numpy(labels), 0.1).backward()
    torch.testing.assert_close(lt.grad[[0, 4]], ce_only.grad[[0, 4]])


def test_entropic_confusion_matches_jax():
    probs = np.random.RandomState(2).dirichlet(np.ones(NC), size=6).astype(np.float32)
    probs[0, 1] = 0.0  # log of 0 is floored at 1e-12 on both sides
    got = pair_confusion.entropic_confusion(torch.from_numpy(probs))
    np.testing.assert_allclose(float(got), float(jpc.entropic_confusion(
        jnp.asarray(probs))), rtol=1e-6)
