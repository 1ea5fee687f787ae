"""The port's CIN and InterpPartsNet Example trainers against the JAX
package's Examples/CIN.py and Examples/InterpPartsNet.py on the CPU, as
test_torch_examples_osme_apinet.py sets out (the same weights, one step of
each trainer pair through its own train step, batch 8, float64 trunks,
the tolerances of test_torch_examples.py).

CIN: resnet18 at 64x64, the recipe's SGD, P x K = 2 x 4. Interp-Parts: the
recipe's SGD with its parameter groups (the backbone at 1x the LR, the
rest at 20x, which the updates show), the JAX class built with
``stage_sizes=(1, 1, 1)``, K = 3, at 96x96, with the soft assignments of
``test_torch_interp_parts.soften`` (that file says why), and in float64
throughout: the JAX module reads its float32 head as float64
(``_Float64Numpy``), and the port's model is cast after its init. With the
float32 head the trunk's first BatchNorm scale updates differed by up to 3%
of the tensor's largest update with one PyTorch thread against the
default. The per-batch cosine of both trainers gives the same LR at every
step of a run, and a resumed run
continues it from ``start_epoch * len(train loader)``."""

import torch_threads  # noqa: F401  (PyTorch's thread count: see the module)
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

import hawkeye_tpu.models  # noqa: F401
import hawkeye_tpu_torch.models  # noqa: F401
from hawkeye_tpu.models.methods.cin import CIN as JaxCIN
from hawkeye_tpu.models.methods import interp_parts as jax_ip
from hawkeye_tpu.models.methods.interp_parts import InterpParts as JaxInterpParts
from hawkeye_tpu_torch.config import setup_config
from hawkeye_tpu_torch.examples.CIN import CINTrainer
from hawkeye_tpu_torch.examples.InterpPartsNet import InterpPartsTrainer
from hawkeye_tpu_torch.losses.cin import CINLoss
from hawkeye_tpu_torch.losses.interp_parts import InterpPartsLoss
from hawkeye_tpu_torch.models.methods.cin import CIN
from hawkeye_tpu_torch.models.methods.interp_parts import InterpParts
from test_torch_examples import _batch, one_step
from test_torch_examples_osme_apinet import NoTensorBoard, example_pair
from test_torch_interp_parts import soften
from test_torch_s3n_mge import _Float64Numpy
from test_torch_trainer import _tiny_recipe_path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from Examples.CIN import CINTrainer as JaxCINTrainer  # noqa: E402
from Examples.InterpPartsNet import InterpPartsTrainer as JaxIPTrainer  # noqa: E402


class JaxF64CINTrainer(JaxCINTrainer):
    def get_model(self, model_config):
        return JaxCIN(num_classes=4, backbone_name="resnet18", r_channel=16,
                      dtype=jnp.float64)


class PortF64CINTrainer(CINTrainer):
    def get_model(self, model_config):
        model = CIN(num_classes=4, backbone_name="resnet18", r_channel=16,
                    image_size=64, dtype=torch.float64)
        model.backbone.to(torch.float64)
        return model


def test_cin_step_matches_jax_example(tmp_path):
    jt, pt = example_pair(tmp_path, JaxF64CINTrainer, PortF64CINTrainer, "CIN.yaml",
                          {"dataset": {"n_classes": 2, "n_samples": 4}}, 30)
    assert isinstance(pt.criterion, CINLoss) and pt.criterion.alpha == 2.0
    assert pt.config.train.optimizer.name == "SGD"
    batch = _batch(31, n=8, size=64)
    batch["label"][:] = [0, 0, 1, 1, 0, 1, 1, 0]  # halves: two pulls, two pushes
    with jax.enable_x64(True):
        one_step(jt, pt, batch, lr=float(pt.config.train.optimizer.lr))


IP_SIZE = {"dataset": {"length": 32, "batch_size": 8,
                       "transformer": {"image_size": 96, "resize_size": 110}},
           "model": {"num_parts": 3}}


class JaxF64IPTrainer(JaxIPTrainer):
    def get_model(self, model_config):
        return JaxInterpParts(num_classes=4, num_parts=3, stage_sizes=(1, 1, 1),
                              dtype=jnp.float64)


class PortF64IPTrainer(InterpPartsTrainer):
    def get_model(self, model_config):
        model = InterpParts(num_classes=4, num_parts=3, stage_sizes=(1, 1, 1),
                            dtype=torch.float64)
        model.backbone.to(torch.float64)
        return model


def test_interp_parts_step_and_groups_match_jax_example(tmp_path, monkeypatch):
    monkeypatch.setattr(jax_ip, "jnp", _Float64Numpy())
    jt, pt = example_pair(tmp_path, JaxF64IPTrainer, PortF64IPTrainer,
                          "InterpPartsNet.yaml", IP_SIZE, 33, edit=lambda v: soften(v, 32))
    pt.model.double()  # the head too (its parameters stay the optimizer's)
    with jax.enable_x64(True):  # the JAX trainer's variables in float64 too
        jt.variables = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jt.variables)
        jt.state = jt.create_state()
    assert isinstance(pt.criterion, InterpPartsLoss) and pt.criterion.coeff == 0.5
    groups = {g["label"]: g for g in pt.optimizer.param_groups}
    assert {k: g["lr_mult"] for k, g in groups.items()} == {"finetune": 1.0,
                                                           "scratch": 20.0}
    backbone = {id(p) for p in pt.model.backbone.parameters()}
    assert {id(p) for p in groups["finetune"]["params"]} == backbone
    assert len(groups["scratch"]["params"]) == len(list(pt.model.parameters())) - len(
        backbone)
    batch = _batch(34, n=8, size=96)
    lr = float(pt.config.train.optimizer.lr)
    with jax.enable_x64(True):
        one_step(jt, pt, batch, lr=lr)
    assert groups["finetune"]["lr"] == lr and groups["scratch"]["lr"] == 20 * lr


def test_interp_parts_cosine_per_batch_and_on_resume(tmp_path):
    over = {**IP_SIZE, "train": {"epoch": 3}}
    path = _tiny_recipe_path("InterpPartsNet.yaml", tmp_path, over)
    from hawkeye_tpu.config import setup_config as jax_setup_config

    class NoInit(NoTensorBoard):  # the schedule needs no JAX model
        def init_model_variables(self):
            return {"params": {}}

        def get_model(self, model_config):
            return None

    jt = type("JaxIP", (NoInit, JaxIPTrainer), {})(jax_setup_config(
        argv=["--config", path]))
    port_cls = type("Port", (NoTensorBoard, PortF64IPTrainer), {})
    pt = port_cls(setup_config(argv=["--config", path]), device="cpu")
    steps = len(pt.dataloaders["train"])
    assert steps == len(jt.dataloaders["train"]) == 4
    base = float(pt.config.train.optimizer.lr)
    lrs = [pt.batch_lr(base) for _ in range(3 * steps)]
    assert lrs == [jt.batch_lr(base) for _ in range(3 * steps)]
    assert lrs[0] == base and lrs[steps] == 0.5 * base * (1 + math.cos(math.pi / 3))
    pt.epoch = 1
    pt.save_checkpoint(os.path.join(str(tmp_path), "ckpt.pt"))
    resumed = port_cls(setup_config(argv=[
        "--config", _tiny_recipe_path("InterpPartsNet.yaml", tmp_path, {
            **over, "experiment": {"resume": os.path.join(str(tmp_path), "ckpt.pt")}})]),
        device="cpu")
    assert resumed.start_epoch == 2
    assert [resumed.batch_lr(base) for _ in range(steps)] == lrs[2 * steps:]
