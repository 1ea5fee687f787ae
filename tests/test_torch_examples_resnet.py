"""The port's Pairwise Confusion Example trainer against the JAX package's
Examples/PairConfusion.py on the CPU: one step of each on the same
synthetic host batch from the port's init (``from_port``: the JAX trainer
starts from it through the bridge, so no JAX init compiles), resnet18
trunks at 96x96, batch 8. The tolerances of test_torch_examples.py. ``_pair`` builds such a pair
for test_torch_examples_mpn.py too.

The trunks run in float64 on both sides (MPN's head is float32 in both
packages whatever the trunk's dtype), as in test_torch_slice_resnet.py:
in float32 a train-mode step of these trunks moves a weight's gradient by
~1e-2 between two right implementations. Both step with SGD in place of
the recipes' Adam (see test_torch_examples.py; their float32 heads leave
~1e-10 of rounding in a gradient, which Adam's first step turns into ~1%
of the LR where a gradient is near its eps, 1e-8)."""

import torch_threads  # noqa: F401  (PyTorch's thread count: see the module)
import os
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

import hawkeye_tpu.models  # noqa: F401
import hawkeye_tpu_torch.models  # noqa: F401
from hawkeye_tpu.config import setup_config as jax_setup_config
from hawkeye_tpu.models.methods.baseline import BaselineClassifier as JaxBaseline
from hawkeye_tpu_torch.config import setup_config
from hawkeye_tpu_torch.examples.PairConfusion import PairConfusionTrainer
from hawkeye_tpu_torch.losses.pair_confusion import PairwiseConfusionLoss
from hawkeye_tpu_torch.models.methods.baseline import BaselineClassifier
from test_torch_examples import _batch, one_step
from test_torch_resnet import TINY
from test_torch_resnet import tiny_trunk  # noqa: F401  (a fixture: pytestmark)
from test_torch_trainer import _tiny_recipe_path, from_port

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from Examples.PairConfusion import PairConfusionTrainer as JaxPCTrainer  # noqa: E402

pytestmark = pytest.mark.usefixtures("tiny_trunk")

SIZE = {"dataset": {"length": 16, "batch_size": 8,
                    "transformer": {"image_size": 96, "resize_size": 110}}}


class JaxF64PCTrainer(JaxPCTrainer):
    def get_model(self, model_config):
        return JaxBaseline(backbone_name=TINY, num_classes=4,
                           dtype=jnp.float64)


class PortF64PCTrainer(PairConfusionTrainer):
    def get_model(self, model_config):
        model = BaselineClassifier(TINY, 4, dtype=torch.float64)
        model.backbone.to(torch.float64)
        return model


def _pair(tmp_path, jax_cls, port_cls, recipe, overrides):
    path = _tiny_recipe_path(recipe, tmp_path, {**SIZE, **overrides})
    pt = port_cls(setup_config(argv=["--config", path]), device="cpu")
    with jax.enable_x64(True):
        jt = from_port(jax_cls, pt.model)(jax_setup_config(argv=["--config", path]))
    return jt, pt


def test_pair_confusion_step_matches_jax_example(tmp_path):
    jt, pt = _pair(tmp_path, JaxF64PCTrainer, PortF64PCTrainer, "PC_resnet50.yaml", {
        "model": {"num_classes": 4},
        "train": {"optimizer": {"name": "SGD", "lr": 0.05, "momentum": 0.9}}})
    assert isinstance(pt.criterion, PairwiseConfusionLoss)
    assert pt.criterion.lambda_a == 0.1
    batch = _batch(3, n=8, size=96)
    batch["label"][:4] = [0, 1, 2, 3]  # the halves' labels differ pairwise
    batch["label"][4:] = [1, 2, 3, 0]
    with jax.enable_x64(True):
        one_step(jt, pt, batch, lr=0.05)
