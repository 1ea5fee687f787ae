"""The port's CrossX Example trainer against the JAX package's
Examples/CrossX.py on the CPU, as test_torch_examples_osme_apinet.py sets
out (the same weights, one step of each trainer through its own train
step, the tolerances of test_torch_examples.py): the model at its fixed
ResNet-50 depth, 32x32 (stage-3 parts 2x2, stage-4 1x1; test_torch_crossx.py
runs 64x64), batch 8, trunk, excitations and fusion in float64
(the three heads are float32 in both packages), the recipe's SGD with
momentum, its CrossX loss, and its MultiStepLR's rate at every epoch."""

import torch_threads  # noqa: F401  (PyTorch's thread count: see the module)
import os
import sys

import jax
import jax.numpy as jnp
import torch

import hawkeye_tpu.models  # noqa: F401
import hawkeye_tpu_torch.models  # noqa: F401
from hawkeye_tpu.models.methods.crossx import CrossXNet as JaxCrossXNet
from hawkeye_tpu_torch.engine.optim import MultiStepLR
from hawkeye_tpu_torch.examples.CrossX import CrossXTrainer
from hawkeye_tpu_torch.losses.crossx import CrossXLoss
from hawkeye_tpu_torch.models.methods.crossx import CrossXNet
from test_torch_examples import _batch, one_step
from test_torch_examples_osme_apinet import example_pair

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from Examples.CrossX import CrossXTrainer as JaxCrossXTrainer  # noqa: E402

SIZE32 = {"dataset": {"transformer": {"image_size": 32, "resize_size": 36}}}


class JaxF64CrossXTrainer(JaxCrossXTrainer):
    def get_model(self, model_config):
        return JaxCrossXNet(num_classes=4, num_parts=2, dtype=jnp.float64)


class PortF64CrossXTrainer(CrossXTrainer):
    def get_model(self, model_config):
        return CrossXNet(num_classes=4, num_parts=2, dtype=torch.float64)


def _to_f64(model):
    """Trunk, excitations and fusion in float64 (in place: the optimizer
    holds the same parameters); the heads stay float32."""
    model.double()
    for head in (model.fc_plty, model.fc_ulti, model.fc_cmbn):
        head.float()


def test_crossx_step_and_schedule_match_jax_example(tmp_path):
    jt, pt = example_pair(tmp_path, JaxF64CrossXTrainer, PortF64CrossXTrainer,
                          "CrossX.yaml", SIZE32, 40)
    _to_f64(pt.model)
    assert isinstance(pt.criterion, CrossXLoss)
    assert pt.criterion.gamma == [0.5, 0.25, 0.5]
    assert isinstance(pt.scheduler, MultiStepLR)
    assert [pt.scheduler.epoch_lr(e) for e in range(60)] == [
        jt.scheduler.epoch_lr(e) for e in range(60)]
    opt = pt.config.train.optimizer
    assert opt.name == "SGD" and float(opt.momentum) == 0.9
    with jax.enable_x64(True):
        one_step(jt, pt, _batch(41, n=8, size=32), lr=float(opt.lr))
