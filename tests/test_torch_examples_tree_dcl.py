"""The port's ProtoTreeNet and DCL Example trainers against the JAX
package's Examples/ProtoTreeNet.py and Examples/DCL.py on the CPU, as
test_torch_examples_osme_apinet.py sets out: the JAX trainer starts from
the port's perturbed init through the bridge (``example_pair``, so no JAX
init compiles), one step of each trainer through its own train step on the
same host batch, the tolerances of test_torch_examples.py; one-block-per-stage trunks
(``TINY``)
in float64 (the heads are float32 in both packages), batch 8 rows.

ProtoTree (64x64, height 3, D = 16, random leaves): SGD in place of the
recipe's AdamW (Adam's first step would amplify the float32 head's
rounding), a step in epoch 0, whose gate zeroes the backbone's gradients,
then one in epoch 30, past it; after each, the leaves rtol 1e-5 / atol 1e-5
of their largest value; the recipe's warm-up cosine at every epoch. With
the recipe's AdamW the frozen backbone takes its steps with zero gradients
(Adam's step count moves, the weights do not).

DCL (112x112, ``swap_num`` [2, 2]: c5 is 4x4, the law 4 cells; batch 4, so
8 rows): the recipe's SGD with the head at ``lr_ratio`` 10 x the base LR
through the groups, on a batch of the port's host collate.

Then each recipe through the port alone, as chip_smoke.py's slice phase
drives it at full size: ProtoTree two epochs with ``FREEZE_EPOCHS`` 1
(backbone unchanged after epoch 0, moved after epoch 1, leaves moved),
``save_tree``/``load_tree`` and the Tester; DCL with either pipeline and the
Tester. And both recipes build at full width with their registered names."""

import torch_threads  # noqa: F401  (PyTorch's thread count: see the module)
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hawkeye_tpu.models  # noqa: F401
import hawkeye_tpu_torch.models  # noqa: F401
from hawkeye_tpu.models.methods.dcl import DCL as JaxDCL
from hawkeye_tpu.models.methods.prototree import ProtoTreeNet as JaxProtoTreeNet
from hawkeye_tpu_torch.config import setup_config
from hawkeye_tpu_torch.engine import Tester
from hawkeye_tpu_torch.examples.DCL import DCLTrainer
from hawkeye_tpu_torch.examples.ProtoTreeNet import ProtoTreeTrainer
from hawkeye_tpu_torch.losses.prototree import ProtoTreeLoss
from hawkeye_tpu_torch.models import load_jax_variables
from hawkeye_tpu_torch.models.methods.dcl import DCL
from hawkeye_tpu_torch.models.methods.prototree import ProtoTreeNet, load_tree, save_tree
from test_torch_examples import _batch, one_step
from test_torch_examples_osme_apinet import NoTensorBoard, example_pair
from test_torch_package import ROOT, example_trainers
from test_torch_resnet import TINY
from test_torch_resnet import tiny_trunk  # noqa: F401  (a fixture: pytestmark)
from test_torch_trainer import _tiny_recipe_path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from Examples.DCL import DCLTrainer as JaxDCLTrainer  # noqa: E402
from Examples.ProtoTreeNet import ProtoTreeTrainer as JaxProtoTreeTrainer  # noqa: E402

pytestmark = pytest.mark.usefixtures("tiny_trunk")

SGD = {"name": "SGD", "lr": 0.05, "momentum": 0.9, "weight_decay": 0.0}
TREE = dict(num_classes=4, height=3, num_features=16, backbone_name=TINY)


class JaxF64ProtoTreeTrainer(JaxProtoTreeTrainer):
    def get_model(self, model_config):
        return JaxProtoTreeNet(dtype=jnp.float64, **TREE)


class PortF64ProtoTreeTrainer(ProtoTreeTrainer):
    def get_model(self, model_config):
        model = ProtoTreeNet(dtype=torch.float64, **TREE)
        model.backbone.to(torch.float64)
        return model


def _random_leaves(variables):
    variables["tree_leaves"] = {"dist_params": np.random.RandomState(31).randn(
        8, 4).astype(np.float32)}


def _assert_leaves_close(jt, pt):
    want = np.asarray(jt.state.extra_vars["tree_leaves"]["dist_params"])
    np.testing.assert_allclose(pt.model.dist_params.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_prototree_steps_across_the_gate_match_jax_example(tmp_path):
    jt, pt = example_pair(tmp_path, JaxF64ProtoTreeTrainer, PortF64ProtoTreeTrainer,
                          "ProtoTreeNet.yaml", {"train": {"optimizer": SGD}}, 30,
                          edit=_random_leaves)
    assert isinstance(pt.criterion, ProtoTreeLoss) and pt.FREEZE_EPOCHS == 30
    assert [pt.scheduler.epoch_lr(e) for e in range(100)] == [
        jt.scheduler.epoch_lr(e) for e in range(100)]
    backbone = {n: p.detach().clone() for n, p in pt.model.backbone.named_parameters()}
    with jax.enable_x64(True):
        one_step(jt, pt, _batch(32, n=8, size=64), lr=0.05)
        _assert_leaves_close(jt, pt)
        assert all(torch.equal(p, backbone[n])
                   for n, p in pt.model.backbone.named_parameters())
        # the same weights again (the momentum buffers differ by rounding);
        # the gate opens and the snapshot is taken anew
        load_jax_variables(pt.model, jax.device_get(jt.model_variables()))
        jt.epoch = pt.epoch = 30
        one_step(jt, pt, _batch(33, n=8, size=64), lr=0.05)
        _assert_leaves_close(jt, pt)
    assert not torch.equal(pt.model.backbone.conv1.weight, backbone["conv1.weight"])
    np.testing.assert_allclose(pt._old_leaf_over_batches.numpy(), np.asarray(
        jt._old_leaf_over_batches), rtol=1e-5, atol=1e-6)


def _tree_recipe(tmp_path, **over):
    return setup_config(argv=["--config", _tiny_recipe_path(
        "ProtoTreeNet.yaml", tmp_path, {
            "dataset": {"num_classes": 4},
            "model": {"backbone": {"name": "resnet18"}, "height": 3,
                      "num_features": 16, "dtype": "float32"}, **over})])


def test_prototree_adamw_steps_the_frozen_backbone_with_zero_gradients(tmp_path):
    pt = type("Port", (NoTensorBoard, ProtoTreeTrainer), {})(
        _tree_recipe(tmp_path), device="cpu")
    assert pt.optimizer.__class__.__name__ == "AdamW"
    before = {n: p.detach().clone() for n, p in pt.model.named_parameters()}
    for seed in (34, 35):  # no epoch hook: step_extras takes the snapshot
        pt.train_step_call(pt.prepare_batch(_batch(seed, n=4, size=64), train=True),
                           1e-3)
    for n, p in pt.model.named_parameters():
        assert torch.equal(p, before[n]) == n.startswith("backbone."), n
        assert int(pt.optimizer.state[p]["step"]) == 2, n
    assert pt._step_inputs_epoch == 0


class JaxF64DCLTrainer(JaxDCLTrainer):
    def get_model(self, model_config):
        return JaxDCL(num_classes=4, backbone_name=TINY, dtype=jnp.float64)


class PortF64DCLTrainer(DCLTrainer):
    def get_model(self, model_config):
        model = DCL(4, backbone_name=TINY, dtype=torch.float64)
        model.backbone.to(torch.float64)
        return model


DCL_SIZE = {"dataset": {"length": 8, "batch_size": 4,
                        "transformer": {"image_size": 112, "resize_size": 128,
                                        "swap_num": [2, 2]}}}


def test_dcl_step_and_groups_match_jax_example(tmp_path):
    jt, pt = example_pair(tmp_path, JaxF64DCLTrainer, PortF64DCLTrainer, "DCL.yaml",
                          DCL_SIZE, 36)
    opt = pt.config.train.optimizer
    assert opt.name == "SGD" and float(opt.lr_ratio) == 10
    lr = float(opt.lr) * 100  # a step that moves the weights visibly
    groups = {g["label"]: g for g in pt.optimizer.param_groups}
    assert {k: g["lr_mult"] for k, g in groups.items()} == {"base": 1.0, "head": 10.0}
    names = {id(p): n for n, p in pt.model.named_parameters()}
    assert sorted(names[id(p)] for p in groups["head"]["params"]) == [
        "classifier.weight", "classifier_swap.weight", "convmask.bias",
        "convmask.weight"]
    rs = np.random.RandomState(37)
    items = [{"img": rs.randint(0, 256, (112, 112, 3)).astype(np.uint8),
              "label": int(rs.randint(0, 4))} for _ in range(4)]
    batch = pt.collate_fn["train"](items)
    assert batch["img"].shape == (8, 112, 112, 3) and batch["swap_law"].shape == (8, 4)
    with jax.enable_x64(True):
        m = one_step(jt, pt, batch, lr=lr)
    assert float(m["count"]) == 8.0  # all 2B rows
    assert {g["label"]: g["lr"] for g in pt.optimizer.param_groups} == {
        "base": lr, "head": 10 * lr}


def test_prototree_trains_saves_the_tree_and_tests_through_the_port(tmp_path):
    cfg = _tree_recipe(tmp_path, train={"epoch": 2})
    tr = type("Port", (NoTensorBoard, ProtoTreeTrainer), {})(cfg, device="cpu")
    tr.FREEZE_EPOCHS = 1
    snaps = []

    def on_end_epoch():
        snaps.append(({n: p.detach().clone() for n, p in
                       tr.model.backbone.named_parameters()},
                      tr.model.dist_params.clone()))

    start = ({n: p.detach().clone() for n, p in tr.model.backbone.named_parameters()},
             tr.model.dist_params.clone())
    tr.on_end_epoch = on_end_epoch
    tr.train()
    (bb0, leaves0), (bb1, leaves1) = snaps
    assert all(torch.equal(bb0[n], v) for n, v in start[0].items())
    assert not torch.equal(bb1["conv1.weight"], bb0["conv1.weight"])
    assert not torch.equal(leaves0, start[1]) and not torch.equal(leaves1, leaves0)
    x = torch.from_numpy(_batch(38, n=2, size=64)["img"])
    save_tree(str(tmp_path / "tree"), tr.model)
    with torch.no_grad():
        want = tr.model.eval()(x)["logits"]
        assert torch.equal(load_tree(str(tmp_path / "tree")).eval()(x)["logits"], want)
    # the best model is the last (val accuracy ties count), tested on the
    # Trainer's val split
    val = tr.performance_meters["val"]["acc"]
    assert val.values[1] >= val.values[0]
    best = os.path.join(tr.log_root, "best_model.msgpack")
    over = dict(cfg.to_dict(), model=dict(cfg.model.to_dict(), load=best),
                dataset=dict(cfg.dataset.to_dict(), length=len(tr.datasets["val"])))
    tester = Tester(setup_config(argv=["--config", _tiny_recipe_path(
        "ProtoTreeNet.yaml", tmp_path, over)]), device="cpu")
    assert torch.equal(tester.model.dist_params, tr.model.dist_params)
    assert tester.test() == val.value


@pytest.mark.parametrize("pipeline", ["host", "device"])
def test_dcl_trains_and_tests_through_the_port(tmp_path, pipeline):
    over = {"dataset": {**DCL_SIZE["dataset"], "pipeline": pipeline, "num_classes": 4,
                        "transformer": {**DCL_SIZE["dataset"]["transformer"],
                                        "rotate": 15}},
            "model": {"backbone": "resnet18"}, "train": {"epoch": 1}}
    cfg = setup_config(argv=["--config", _tiny_recipe_path("DCL.yaml", tmp_path, over)])
    tr = type("Port", (NoTensorBoard, DCLTrainer), {})(cfg, device="cpu")
    batch = tr.prepare_batch(next(iter(tr.dataloaders["train"])), train=True)
    if pipeline == "device":
        assert batch["img"].dtype == torch.uint8 and batch["img"].shape[1] == 128
        batch = tr.device_prepare_train(torch.Generator().manual_seed(0), batch)
    assert batch["img"].shape == (8, 112, 112, 3)
    assert batch["label_swap"].tolist() == [1] * 4 + [0] * 4
    tr.train()
    assert tr.step == 2
    best = os.path.join(tr.log_root, "best_model.msgpack")
    tester = Tester(setup_config(argv=["--config", _tiny_recipe_path("DCL.yaml", tmp_path, {
        **over, "dataset": {**over["dataset"], "length": len(tr.datasets["val"])},
        "model": {"backbone": "resnet18", "load": best}})]), device="cpu")
    assert tester.test() == tr.performance_meters["val"]["acc"].value


@pytest.mark.parametrize("name,model_cls,loss,prefixes", [
    ("ProtoTreeNet.yaml", "ProtoTreeNet", "ProtoTreeLoss",
     {"backbone", "neck_conv", "prototypes"}),
    ("DCL.yaml", "DCL", "DCLLoss",
     {"backbone", "convmask", "classifier", "classifier_swap"})])
def test_recipe_builds_at_full_width(name, model_cls, loss, prefixes):
    from hawkeye_tpu_torch import LOSS
    from hawkeye_tpu_torch.losses import build_criterion
    from hawkeye_tpu_torch.models import build_model

    cfg = setup_config(argv=["--config", os.path.join(ROOT, "configs", name)])
    model = build_model(cfg.model, cfg.dataset.transformer.image_size)
    assert type(model).__name__ == model_cls
    assert {n.split(".")[0] for n, _ in model.named_parameters()} == prefixes
    crit = build_criterion(cfg.train.criterion)
    assert type(crit).__name__ == loss and LOSS.get(loss) is type(crit)
    assert name.split(".")[0] in example_trainers()
    if model_cls == "ProtoTreeNet":
        assert model.prototypes.shape == (511, 256) and model.dist_params.shape == (512, 200)
        assert model.neck_conv.weight.shape == (256, 2048, 1, 1)
    else:
        assert model.classifier_swap.out_features == 2
        assert model.backbone.feature_size(448) == 14  # an even c5: a 7x7 mask
