"""The port's OSMENet and APINet Example trainers against the JAX
package's Examples/OSMENet.py and Examples/APINet.py on the CPU: one step
of each trainer pair on the same synthetic host batch from the same
weights, through each trainer's own train step, tolerances of
test_torch_examples.py. One-block-per-stage trunks (``TINY``) in float64 at
64x64 (see
test_torch_examples_resnet.py), batch 8 (the JAX trainer pads a batch to
its 8 CPU devices, and padded rows would enter the batch statistics).

The weights are the port's init with random BatchNorm scales and biases
(``test_torch_osme.perturbed``), handed to the JAX trainer as its initial
variables (``example_pair``), so no JAX init compiles.

OSME: the recipe's SGD and MAMC loss, P x K = 4 x 2 (the recipe's 5 x 2
would give batch 10). API-Net: SGD in place of the recipe's Adam (see
test_torch_examples_resnet.py) and dropout off on both sides (flax and the
port draw their masks from different generators), a step in epoch 1. In
epoch 0 the gate zeroes the backbone's gradients, and the recipe's Adam
moves the backbone by its coupled decay alone, as optax's
``add_decayed_weights`` + Adam does: the port's backbone update equals
optax's on the same parameters with zero gradients, rtol 1e-5."""

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
from hawkeye_tpu.config import setup_config as jax_setup_config
from hawkeye_tpu.models.methods.apinet import APINet as JaxAPINet
from hawkeye_tpu.models.methods.osme import OSMENet as JaxOSMENet
from hawkeye_tpu_torch.config import setup_config
from hawkeye_tpu_torch.data import BalancedBatchSampler
from hawkeye_tpu_torch.examples.APINet import APINetTrainer
from hawkeye_tpu_torch.examples.OSMENet import OSMETrainer
from hawkeye_tpu_torch.losses.mamc import MAMCLoss
from hawkeye_tpu_torch.models import export_jax_variables, load_jax_variables
from hawkeye_tpu_torch.models.methods.apinet import APINet
from hawkeye_tpu_torch.models.methods.osme import OSMENet
from hawkeye_tpu.engine.optim import build_optimizer as jax_build_optimizer
from test_torch_examples import _batch, one_step
from test_torch_osme import perturbed
from test_torch_resnet import TINY, _assert_close_scaled, _leaves
from test_torch_resnet import tiny_trunk  # noqa: F401  (a fixture: pytestmark)
from test_torch_trainer import _tiny_recipe_path, from_port

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from Examples.APINet import APINetTrainer as JaxAPINetTrainer  # noqa: E402
from Examples.OSMENet import OSMETrainer as JaxOSMETrainer  # noqa: E402

pytestmark = pytest.mark.usefixtures("tiny_trunk")

SIZE = {"dataset": {"length": 16, "batch_size": 8,
                    "transformer": {"image_size": 64, "resize_size": 72}}}


class NoTensorBoard:
    """Mixed into a test trainer: no event file (closing one can hold the
    test for many seconds)."""

    def get_tb_writer(self):
        return None


def example_pair(tmp_path, jax_cls, port_cls, recipe, overrides, seed, edit=None):
    """A JAX and a port Example trainer of ``recipe`` at test size, the JAX
    one starting from the port's perturbed init (``edit`` may change those
    variables first). The JAX trainer runs in float64 mode."""
    path = _tiny_recipe_path(recipe, tmp_path, {**SIZE, **overrides})
    pt = type(port_cls.__name__, (NoTensorBoard, port_cls), {})(
        setup_config(argv=["--config", path]), device="cpu")
    variables = perturbed(export_jax_variables(pt.model), seed)
    if edit is not None:
        edit(variables)
    load_jax_variables(pt.model, variables)
    jax_cls = from_port(type(jax_cls.__name__, (NoTensorBoard, jax_cls), {}), pt.model)
    with jax.enable_x64(True):
        jt = jax_cls(jax_setup_config(argv=["--config", path]))
    return jt, pt


class JaxF64OSMETrainer(JaxOSMETrainer):
    def get_model(self, model_config):
        return JaxOSMENet(num_classes=4, backbone_name=TINY, dtype=jnp.float64)


class PortF64OSMETrainer(OSMETrainer):
    def get_model(self, model_config):
        model = OSMENet(num_classes=4, backbone_name=TINY, image_size=64,
                        dtype=torch.float64)
        for m in (model.backbone, model.osme_0, model.osme_1):
            m.to(torch.float64)  # part_fc and fc stay float32, as in JAX
        return model


def test_osme_step_matches_jax_example(tmp_path):
    jt, pt = example_pair(tmp_path, JaxF64OSMETrainer, PortF64OSMETrainer,
                          "OSMENet.yaml", {"dataset": {"n_classes": 4}}, 20)
    assert isinstance(pt.dataloaders["train"].batch_sampler, BalancedBatchSampler)
    assert isinstance(pt.criterion, MAMCLoss) and pt.criterion.lambda_a == 0.5
    assert pt.config.train.optimizer.name == "SGD"
    batch = _batch(21, n=8, size=64)
    batch["label"][:] = [0, 0, 2, 2, 1, 1, 3, 3]
    with jax.enable_x64(True):
        one_step(jt, pt, batch, lr=float(pt.config.train.optimizer.lr))


class JaxF64APINetTrainer(JaxAPINetTrainer):
    def get_model(self, model_config):
        return JaxAPINet(num_classes=4, backbone_name=TINY, feature_dim=512,
                         dropout_rate=0.0, dtype=jnp.float64)


class PortF64APINetTrainer(APINetTrainer):
    def get_model(self, model_config):
        model = APINet(num_classes=4, backbone_name=TINY, dropout_rate=0.0,
                       dtype=torch.float64)
        model.backbone.to(torch.float64)
        return model


def test_apinet_step_matches_jax_example(tmp_path):
    sgd = {"name": "SGD", "lr": 0.05, "momentum": 0.9, "weight_decay": 1e-4}
    jt, pt = example_pair(tmp_path, JaxF64APINetTrainer, PortF64APINetTrainer,
                          "APINet.yaml", {"dataset": {"n_classes": 4, "n_samples": 2},
                                          "train": {"optimizer": sgd}}, 22)
    batch = _batch(23, n=8, size=64)
    batch["label"][:] = [1, 1, 0, 0, 3, 3, 2, 2]
    jt.epoch = pt.epoch = 1  # past the gate
    with jax.enable_x64(True):
        one_step(jt, pt, batch, lr=0.05)


def test_apinet_adam_moves_the_backbone_by_its_decay_in_epoch0(tmp_path):
    path = _tiny_recipe_path("APINet.yaml", tmp_path, {
        **SIZE, "dataset": {**SIZE["dataset"], "n_classes": 4, "n_samples": 2}})
    pt = type("Port", (NoTensorBoard, PortF64APINetTrainer), {})(
        setup_config(argv=["--config", path]), device="cpu")
    opt = pt.config.train.optimizer
    assert opt.name == "Adam" and float(opt.weight_decay) == 2e-8
    lr = float(opt.lr)
    params = export_jax_variables(pt.model.backbone)["params"]
    before = {n: p.detach().clone() for n, p in pt.model.backbone.named_parameters()}
    assert pt.epoch == 0
    pt.train_step_call(pt.prepare_batch(_batch(25, n=8, size=64), train=True), lr)
    # optax: the recipe's Adam on the backbone with the gate's zero gradients
    tx, _ = jax_build_optimizer(opt)
    state = tx.init(params)
    state.hyperparams["learning_rate"] = jnp.asarray(lr, jnp.float32)
    updates = jax.device_get(jax.jit(tx.update)(
        jax.tree_util.tree_map(jnp.zeros_like, params), state, params)[0])
    moved = {n: (p.detach() - before[n]).float() for n, p in
             pt.model.backbone.named_parameters()}
    with torch.no_grad():  # the moves in the flax layout
        for n, p in pt.model.backbone.named_parameters():
            p.copy_(moved[n])
    got = export_jax_variables(pt.model.backbone)["params"]
    _assert_close_scaled(got, updates, rtol=1e-5, scale_tol=1e-6)
    assert all(np.abs(v).max() > 0 for k, v in _leaves(updates).items()
               if k.endswith("['kernel']"))
