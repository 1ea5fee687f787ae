"""The port's NTSNet and APCNN Example trainers against the JAX package's
Examples/NTSNet.py and Examples/APCNN.py on the CPU, as
test_torch_examples_osme_apinet.py sets out: the JAX trainer starts from
the port's perturbed init through the bridge (``example_pair``, so no JAX
init compiles), one step of each trainer through its own train step on the
same host batch, the tolerances of test_torch_examples.py; trunks in
float64 (the heads, and AP-CNN's attention, are float32 in both packages),
batch 8 (the JAX trainer's 8 CPU devices), 32x32 (the smallest input both
models' anchor grids take: a 1x1 c5).

NTS-Net (``TINY``, ``pad_side = part_size = 32``, M = 4, K = 3): SGD in
place of the recipe's Adam (Adam's first step would amplify the float32
heads' rounding) and dropout the identity on both sides (flax's at rate 0,
the port's ``dropout_rate`` set to 0). AP-CNN (``stage_sizes=(1, 1, 1, 1)``,
``fpn_dim`` 32): the recipe's SGD with the trunk at 0.1x the heads' LR
through the groups, and the dropblock on the same draws (the JAX module's
``jax.random`` gives them, the port's model draws them from the trainer's
generator).

Then each recipe through the port alone, as chip_smoke.py's slice phase
drives it at full size, with the small models in float32 at 64x64: one
epoch with validation, the Tester on the best model (top-1 equal to the
trainer's, logits equal to the trained model's), with ``fused_part_pass``
for NTS-Net.
"""

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
from hawkeye_tpu.models.methods import apcnn as jax_apcnn
from hawkeye_tpu.models.methods import ntsnet as jax_ntsnet
from hawkeye_tpu_torch.config import setup_config
from hawkeye_tpu_torch.engine import Tester
from hawkeye_tpu_torch.examples.APCNN import APCNNTrainer
from hawkeye_tpu_torch.examples.NTSNet import NTSNetTrainer
from hawkeye_tpu_torch.losses.apcnn import APCNNLoss
from hawkeye_tpu_torch.losses.nts import NTSLoss
from hawkeye_tpu_torch.models.methods.apcnn import APCNN
from hawkeye_tpu_torch.models.methods.ntsnet import NTSNet
from test_torch_examples import _batch, one_step
from test_torch_examples_osme_apinet import NoTensorBoard, example_pair
from test_torch_ntsnet import _NoDropout
from test_torch_resnet import TINY
from test_torch_resnet import tiny_trunk  # noqa: F401  (a fixture: pytestmark)
from test_torch_trainer import _tiny_recipe_path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from Examples.APCNN import APCNNTrainer as JaxAPCNNTrainer  # noqa: E402
from Examples.NTSNet import NTSNetTrainer as JaxNTSNetTrainer  # noqa: E402

pytestmark = pytest.mark.usefixtures("tiny_trunk")

SGD = {"name": "SGD", "lr": 0.05, "momentum": 0.9, "weight_decay": 1e-4}
SIZE32 = {"dataset": {"transformer": {"image_size": 32, "resize_size": 36}}}
NTS = dict(num_classes=4, proposal_num=4, cat_num=3, image_size=32, pad_side=32,
           part_size=32, backbone_name=TINY)
AP = dict(num_classes=4, image_size=32, stage_sizes=(1, 1, 1, 1), fpn_dim=32)
DRAWS = {"pro": np.array([0.1, 0.45, 0.8, 0.2, 0.5, 0.7, 0.25, 0.9]),
         "i3": np.array([0, 3, 1, 4, 2, 0, 1, 3]), "i4": np.array([2, 0, 1, 1, 0, 2, 2, 1])}


class JaxF64NTSNetTrainer(JaxNTSNetTrainer):
    def get_model(self, model_config):
        return jax_ntsnet.NTSNet(dtype=jnp.float64, **NTS)


class PortF64NTSNetTrainer(NTSNetTrainer):
    def get_model(self, model_config):
        model = NTSNet(dtype=torch.float64, **NTS)
        model.dropout_rate = 0.0
        model.backbone.to(torch.float64)
        model.proposal_net.to(torch.float64)
        return model


def test_ntsnet_step_matches_jax_example(tmp_path, monkeypatch):
    monkeypatch.setattr(jax_ntsnet, "nn", _NoDropout())
    jt, pt = example_pair(tmp_path, JaxF64NTSNetTrainer, PortF64NTSNetTrainer,
                          "NTSNet.yaml", {**SIZE32, "train": {"optimizer": SGD}}, 40)
    assert isinstance(pt.criterion, NTSLoss)
    assert [pt.scheduler.epoch_lr(e) for e in range(0, 200, 7)] == [
        jt.scheduler.epoch_lr(e) for e in range(0, 200, 7)]  # warm-up cosine
    with jax.enable_x64(True):
        one_step(jt, pt, _batch(41, n=8, size=32), lr=0.05)


class JaxF64APCNNTrainer(JaxAPCNNTrainer):
    def get_model(self, model_config):
        return jax_apcnn.APCNN(dtype=jnp.float64, **AP)


class PortF64APCNNTrainer(APCNNTrainer):
    def get_model(self, model_config):
        model = APCNN(dtype=torch.float64, **AP)
        for name, mod in model.named_children():  # the trunk and the FPN
            if not name.startswith(("a3", "a4", "a5", "cls")):
                mod.to(torch.float64)
        return model


def test_apcnn_step_and_groups_match_jax_example(tmp_path, monkeypatch):
    from test_torch_apcnn import _fixed_random

    monkeypatch.setattr("test_torch_apcnn.DRAWS", DRAWS)
    monkeypatch.setattr(jax_apcnn, "jax", _fixed_random())
    jt, pt = example_pair(tmp_path, JaxF64APCNNTrainer, PortF64APCNNTrainer,
                          "APCNN.yaml", SIZE32, 42)
    drawn = []

    def fixed_draws(generator, b):
        drawn.append(generator)
        return {k: torch.from_numpy(v) for k, v in DRAWS.items()}

    pt.model.dropblock_draws = fixed_draws
    opt = pt.config.train.optimizer
    assert opt.name == "SGD" and isinstance(pt.criterion, APCNNLoss)
    lr = float(opt.lr) * 50  # a step that moves the weights visibly
    groups = {g["label"]: g for g in pt.optimizer.param_groups}
    assert {k: g["lr_mult"] for k, g in groups.items()} == {"trunk": 0.1, "head": 1.0}
    names = {id(p): n.split(".")[0] for n, p in pt.model.named_parameters()}
    assert {names[id(p)] for p in groups["trunk"]["params"]} == {
        "conv1", "bn1", "layer1_0", "layer2_0", "layer3_0", "layer4_0"}
    with jax.enable_x64(True):
        one_step(jt, pt, _batch(43, n=8, size=32), lr=lr)
    assert drawn == [pt._model_generator]  # one train forward, the trainer's stream
    assert {g["label"]: g["lr"] for g in pt.optimizer.param_groups} == {
        "trunk": 0.1 * lr, "head": lr}


# the port-only runs' models: float32 and small (a bfloat16 trunk is slow on
# the CPU); the recipes' own models at full width are built by
# test_torch_package.py
PORT_MODELS = {"NTSNet.yaml": lambda: NTSNet(dtype=torch.float32, fused_part_pass=True,
                                             **dict(NTS, image_size=64, pad_side=64,
                                                    part_size=64)),
               "APCNN.yaml": lambda: APCNN(dtype=torch.float32, **dict(AP, image_size=64))}


def _port_run(tmp_path, recipe, trainer_cls):
    """One epoch of ``recipe`` through the port at test size, then the
    Tester on its best model: top-1 equal to the trainer's best val
    accuracy, logits on a val batch equal to the trained model's."""
    def get_model(self, model_config):
        return PORT_MODELS[recipe]()

    over = {"model": {"num_classes": 4}, "train": {"epoch": 1, "val_first": False}}
    cfg = setup_config(argv=["--config", _tiny_recipe_path(recipe, tmp_path, over)])
    tr = type("Port", (NoTensorBoard, trainer_cls), {"get_model": get_model})(
        cfg, device="cpu")
    tr.train()
    assert tr.step == 2
    val = tr.prepare_batch(next(iter(tr.dataloaders["val"])), train=False)
    with torch.no_grad():
        logits = tr.model.eval()(val["img"])["logits"]
    best = os.path.join(tr.log_root, "best_model.msgpack")
    tester = type("PortTester", (Tester,), {"get_model": get_model})(
        setup_config(argv=["--config", _tiny_recipe_path(recipe, tmp_path, {
            **over, "dataset": {"length": len(tr.datasets["val"])},
            "model": {"load": best}})]), device="cpu")
    assert tester.test() == tr.performance_meters["val"]["acc"].best_value
    with torch.no_grad():
        assert torch.equal(tester.model(val["img"])["logits"], logits)
    return tr


@pytest.mark.parametrize("recipe,trainer_cls", [("NTSNet.yaml", NTSNetTrainer),
                                                ("APCNN.yaml", APCNNTrainer)],
                         ids=["ntsnet_fused", "apcnn"])
def test_recipe_trains_and_tests_through_the_port(tmp_path, recipe, trainer_cls):
    tr = _port_run(tmp_path, recipe, trainer_cls)
    if recipe == "APCNN.yaml":
        assert {g["label"] for g in tr.optimizer.param_groups} == {"trunk", "head"}
    else:
        assert tr.model.fused_part_pass and tr.model.dropout_rate == 0.5
