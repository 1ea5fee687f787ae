"""The second slice as a whole, on the CPU against the JAX package: the
port's Trainer with ``dataset.pipeline: device`` takes one SGD step of a
Baseline ResNet-18 (32 px, batch 8) on the same augmented batch as the JAX
Trainer's own first step, from bridged weights.

Tolerances, as in test_torch_trainer.py: loss rtol 1e-4; each parameter's
update rtol 1e-3 with an atol of 1e-3 of the tensor's largest update plus
four float32 ulps of the parameter; the running statistics rtol 1e-5 with
an atol of 1e-5 of each tensor's largest value."""

import torch_threads  # noqa: F401  (PyTorch's thread count: see the module)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hawkeye_tpu.models  # noqa: F401
import hawkeye_tpu_torch.models  # noqa: F401
from hawkeye_tpu.config import setup_config as jax_setup_config
from hawkeye_tpu.engine import Trainer as JaxTrainer
from hawkeye_tpu.models.methods.baseline import BaselineClassifier as JaxBaseline
from hawkeye_tpu_torch.config import setup_config
from hawkeye_tpu_torch.engine import Trainer
from hawkeye_tpu_torch.models import export_jax_variables
from hawkeye_tpu_torch.models.methods.baseline import BaselineClassifier
from test_torch_resnet import TINY, _assert_close_scaled
from test_torch_resnet import tiny_trunk  # noqa: F401  (a fixture: pytestmark)
from test_torch_tester import SLICE, _recipe
from test_torch_trainer import _assert_updates_close, from_port

pytestmark = pytest.mark.usefixtures("tiny_trunk")


class JaxF64Trainer(JaxTrainer):
    def get_model(self, model_config):
        return JaxBaseline(backbone_name=TINY, num_classes=5,
                           dtype=jnp.float64)

    def device_prepare_train(self, rng, batch):
        return dict(batch, img=jnp.asarray(self.augmented))


class PortF64Trainer(Trainer):
    def get_model(self, model_config):
        model = BaselineClassifier(TINY, 5, dtype=torch.float64)
        model.backbone.to(torch.float64)  # the float32 head reads a float32 pool
        return model

    def device_prepare_train(self, generator, batch):
        assert generator.device == self.device
        return dict(batch, img=torch.from_numpy(self.augmented))


def test_device_pipeline_step_matches_jax_trainer(tmp_path):
    """The trunk runs in float64 on both sides (float32 parameters in JAX):
    in float32 a pre-ReLU value within rounding of zero can land on the
    other side in one framework and move a weight's gradient by ~1%, as in
    test_torch_resnet_train.py. The augmentation runs as the JAX Trainer's
    first step runs it, in float32, with that step's key."""
    path = _recipe(tmp_path, SLICE)
    pt = PortF64Trainer(setup_config(argv=["--config", path]), device="cpu")
    with jax.enable_x64(True):  # from the port's init (no JAX init compiles)
        jt = from_port(JaxF64Trainer, pt.model)(jax_setup_config(argv=["--config", path]))
    assert len(pt.dataloaders["train"]) == len(jt.dataloaders["train"]) == 1
    host = next(iter(jt.dataloaders["train"]))
    assert host["img"].dtype == np.uint8 and host["img"].shape == (8, 40, 40, 3)
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(jt.seed), 0), 1)
    jt.augmented = pt.augmented = np.array(jt.device_augment(key, host["img"]))
    with jax.enable_x64(True):
        jax_before = jax.device_get(jt.state.params)
        port_before = export_jax_variables(pt.model)["params"]

        lr = float(pt.config.train.optimizer.lr)
        jt.state, mj = jt.train_step_call(jt.prepare_batch(host, train=True),
                                          jnp.asarray(lr, jnp.float32))
        mp = pt.train_step_call(pt.prepare_batch(host, train=True), lr)
        jax_after = jax.device_get(jt.state.params)
        jax_stats = jax.device_get(jt.state.batch_stats)

    np.testing.assert_allclose(float(mp["loss"]), float(mj["loss"]), rtol=1e-4)
    assert float(mp["correct"]) == float(mj["correct"])
    after = export_jax_variables(pt.model)
    _assert_updates_close(port_before, after["params"], jax_before, jax_after)
    _assert_close_scaled(after["batch_stats"], jax_stats, rtol=1e-5, scale_tol=1e-5)
