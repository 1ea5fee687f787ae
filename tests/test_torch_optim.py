"""The port's optimizers, schedulers and criterion (hawkeye_tpu_torch/engine/
optim.py, losses) against the JAX package's optax chains and host
schedulers: the same gradients over several steps give the same parameters
(float32, rtol 1e-5 for SGD, 1e-4 for Adam's square roots)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hawkeye_tpu.config import ConfigNode as JaxConfigNode
from hawkeye_tpu.engine import optim as jax_optim
from hawkeye_tpu.losses import cross_entropy as jax_cross_entropy
from hawkeye_tpu_torch.config import ConfigNode
from hawkeye_tpu_torch.engine import optim as port_optim
from hawkeye_tpu_torch.losses import build_criterion, cross_entropy

GRADS = [np.array([0.1, -0.2, 0.3, 0.0], np.float32) * (i + 1) for i in range(6)]
X0 = np.array([1.0, 2.0, -3.0, 0.5], np.float32)


def _run_optax(cfg, grads):
    tx, _ = jax_optim.build_optimizer(JaxConfigNode(cfg))
    params = {"w": jnp.asarray(X0)}
    state = tx.init(params)
    for g in grads:
        updates, state = tx.update({"w": jnp.asarray(g)}, state, params)
        params = {"w": params["w"] + updates["w"]}
    return np.asarray(params["w"])


def _run_port(cfg, grads):
    w = torch.nn.Parameter(torch.tensor(X0))
    opt, base_lr = port_optim.build_optimizer(ConfigNode(cfg), [w])
    assert base_lr == cfg["lr"]
    for g in grads:
        opt.zero_grad()
        w.grad = torch.tensor(g)
        opt.step()
    return w.detach().numpy()


@pytest.mark.parametrize("cfg,rtol", [
    ({"name": "SGD", "lr": 0.1}, 1e-5),
    ({"name": "SGD", "lr": 0.1, "momentum": 0.9, "weight_decay": 0.01}, 1e-5),
    ({"name": "SGD", "lr": 0.1, "momentum": 0.9, "weight_decay": 0.01,
      "nesterov": True}, 1e-5),
    ({"name": "Adam", "lr": 0.001, "weight_decay": 0.01}, 1e-4),
    ({"name": "AdamW", "lr": 0.001, "weight_decay": 0.05}, 1e-4),
], ids=["sgd", "sgd_momentum_wd", "sgd_nesterov", "adam", "adamw"])
def test_optimizer_matches_optax_chain(cfg, rtol):
    np.testing.assert_allclose(_run_port(cfg, GRADS), _run_optax(cfg, GRADS),
                               rtol=rtol, atol=1e-6)


def test_zero_gradient_still_decays_and_accumulates_momentum():
    """A frozen parameter (zero gradient) moves under coupled L2 + momentum
    in optax; the port's zero grad reproduces it."""
    cfg = {"name": "SGD", "lr": 1.0, "momentum": 0.9, "weight_decay": 0.1}
    zeros = [np.zeros_like(X0)] * 3
    np.testing.assert_allclose(_run_port(cfg, zeros), _run_optax(cfg, zeros),
                               rtol=1e-6)
    assert not np.allclose(_run_port(cfg, zeros), X0)


def test_learning_rate_groups():
    a = torch.nn.Parameter(torch.zeros(1))
    b = torch.nn.Parameter(torch.zeros(1))
    opt, _ = port_optim.build_optimizer(
        ConfigNode({"name": "SGD", "lr": 0.1}),
        [{"params": [a]}, {"params": [b], "lr_mult": 0.2}])
    assert [g["lr"] for g in opt.param_groups] == pytest.approx([0.1, 0.02])
    port_optim.set_learning_rate(opt, 0.5)
    assert [g["lr"] for g in opt.param_groups] == pytest.approx([0.5, 0.1])


@pytest.mark.parametrize("cfg", [
    None,
    {"name": "CosineAnnealingLR", "T_max": 7, "eta_min": 0.001},
    {"T_max": 9, "warmup_epochs": 3, "lr_warmup_decay": 0.01},
    {"name": "StepLR", "step_size": 3, "gamma": 0.5},
    {"name": "MultiStepLR", "milestones": [2, 5], "gamma": 0.1},
], ids=["constant", "cosine", "warmup_cosine", "step", "multistep"])
def test_epoch_schedulers_match_jax(cfg):
    port = port_optim.build_scheduler(ConfigNode(cfg) if cfg else None, 0.1)
    ref = jax_optim.build_scheduler(JaxConfigNode(cfg) if cfg else None, 0.1)
    for epoch in range(10):
        assert port.epoch_lr(epoch) == ref.epoch_lr(epoch), epoch


def test_plateau_matches_jax_and_round_trips():
    cfg = {"name": "ReduceLROnPlateau", "patience": 2, "factor": 0.5}
    port = port_optim.build_scheduler(ConfigNode(cfg), 1.0)
    ref = jax_optim.build_scheduler(JaxConfigNode(cfg), 1.0)
    for acc in [50.0, 51.0, 51.0, 51.0, 51.0, 60.0, 59.0, 59.0, 59.0, 59.0]:
        port.step_metric(acc)
        ref.step_metric(acc)
        assert port.epoch_lr(0) == ref.epoch_lr(0)
        assert port.state_dict() == ref.state_dict()
    fresh = port_optim.build_scheduler(ConfigNode(cfg), 1.0)
    fresh.load_state_dict(port.state_dict())
    assert fresh.state_dict() == port.state_dict()


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
@pytest.mark.parametrize("kind", ["int", "soft", "weighted"])
def test_cross_entropy_matches_jax(smoothing, kind):
    rs = np.random.RandomState(0)
    logits = rs.randn(6, 5).astype(np.float32)
    labels = rs.randint(0, 5, size=6)
    weights = None
    if kind == "soft":
        labels = rs.dirichlet(np.ones(5), size=6).astype(np.float32)
    if kind == "weighted":
        weights = np.array([1, 1, 0, 1, 0, 1], np.float32)
    want = float(jax_cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels), smoothing,
        None if weights is None else jnp.asarray(weights)))
    got = float(cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(labels), smoothing,
        None if weights is None else torch.from_numpy(weights)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_build_criterion_defaults_to_smoothed_ce():
    crit = build_criterion(None)
    assert crit.label_smoothing == 0.1
    assert build_criterion(ConfigNode({"name": "CrossEntropyLoss",
                                       "label_smoothing": 0.0})).label_smoothing == 0.0
    with pytest.raises(KeyError):  # a loss not ported yet
        build_criterion(ConfigNode({"name": "NTSLoss"}))


def test_prefix_param_groups_label_like_make_prefix_labeler():
    """Whole name segments only, first rule wins, every parameter in exactly
    one group; the labels are those of the JAX labeler on the same names."""
    from torch import nn

    model = nn.Module()
    model.backbone = nn.Linear(2, 2)
    model.backbone2 = nn.Linear(2, 2)
    model.head = nn.Module()
    model.head.fc = nn.Linear(2, 2)
    rules = {"backbone": "backbone", "head.fc": "fc"}
    groups = port_optim.prefix_param_groups(
        model, rules, {"backbone": 0.2, "fc": 0.5, "head": 1.0})
    by_label = {g["label"]: g for g in groups}
    names = {id(p): n for n, p in model.named_parameters()}
    got = {names[id(p)]: g["label"] for g in groups for p in g["params"]}
    assert sorted(got) == sorted(names.values())  # each parameter once
    tree = {"backbone": {"kernel": 0, "bias": 0}, "backbone2": {"kernel": 0, "bias": 0},
            "head": {"fc": {"kernel": 0, "bias": 0}}}
    want = jax_optim.make_prefix_labeler(rules)(tree)
    for name, label in got.items():
        *path, leaf = name.split(".")
        node = want
        for seg in path:
            node = node[seg]
        assert node[{"weight": "kernel"}.get(leaf, leaf)] == label, name
    assert got["backbone2.weight"] == "head"
    assert {k: g["lr_mult"] for k, g in by_label.items()} == {
        "backbone": 0.2, "fc": 0.5, "head": 1.0}
    with pytest.raises(KeyError, match="no multiplier"):
        port_optim.prefix_param_groups(model, rules, {"backbone": 0.2, "head": 1.0})
