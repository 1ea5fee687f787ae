"""The third slice's Example trainers (hawkeye_tpu_torch/examples) against
the JAX package's Examples/ on the CPU, one file per recipe's step so each
runs well under a minute: here CBCNN stage 2, Peer-Learning's in
test_torch_examples_peer.py, MPN's in test_torch_examples_mpn.py, Pairwise
Confusion's in test_torch_examples_resnet.py; the two-stage flows through
the recipes in configs/ in test_torch_examples_flows.py.

One step of each trainer pair on the same synthetic host batch, from
bridged weights, through each trainer's own train step, as
test_torch_trainer.py does: the loss within rtol 1e-4 and every parameter's
update rtol 1e-3 with an atol of 1e-3 of the tensor's largest update plus
four float32 ulps of the parameter. Here: CBCNN stage 2 (vgg11, 64x64,
d = 64, float32, the recipe's SGD)."""

import torch_threads  # noqa: F401  (PyTorch's thread count: see the module)
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

import hawkeye_tpu.models  # noqa: F401
import hawkeye_tpu_torch.models  # noqa: F401
from hawkeye_tpu.config import setup_config as jax_setup_config
from hawkeye_tpu.models.methods.cbcnn import CBCNN as JaxCBCNN
from hawkeye_tpu_torch.config import setup_config
from hawkeye_tpu_torch.examples.CBCNN import CBCNNTrainer
from hawkeye_tpu_torch.models import export_jax_variables, load_jax_variables
from hawkeye_tpu_torch.models.methods.cbcnn import CBCNN
from test_torch_package import example_trainers
from test_torch_trainer import _assert_updates_close, _tiny_recipe_path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from Examples.CBCNN import CBCNNTrainer as JaxCBCNNTrainer  # noqa: E402


def _batch(seed, n=4, classes=4, size=64):
    rs = np.random.RandomState(seed)
    return {"img": rs.randn(n, size, size, 3).astype(np.float32),
            "label": rs.randint(0, classes, n).astype(np.int64)}


class JitInit:
    """Mixed into a JAX trainer: its model's init runs as one compiled
    program, not op by op (~10 s less on the CPU). The port's model takes
    whatever weights it makes through the bridge."""

    def init_model_variables(self):
        kwargs = self.init_model_kwargs()

        def init(rng, x):
            return self.model.init({"params": rng, "dropout": jax.random.fold_in(rng, 1)},
                                   x, train=True, **kwargs)

        return jax.jit(init)(jax.random.PRNGKey(self.seed), self.example_input())


def one_step(jt, pt, batch, lr, keys=("correct",)):
    """One train step of each trainer on ``batch``; checks the loss, the
    metrics in ``keys`` and every parameter's update."""
    jax_before = jax.device_get(jt.state.params)
    port_before = export_jax_variables(pt.model)["params"]
    jt.state, mj = jt.train_step_call(jt.prepare_batch(batch, train=True),
                                      jnp.asarray(lr, jnp.float32))
    mp = pt.train_step_call(pt.prepare_batch(batch, train=True), lr)
    np.testing.assert_allclose(float(mp["loss"]), float(mj["loss"]), rtol=1e-4)
    for k in keys:
        assert float(mp[k]) == float(mj[k]), k
    _assert_updates_close(port_before, export_jax_variables(pt.model)["params"],
                          jax_before, jax.device_get(jt.state.params))
    return mp


def test_example_trainers_keep_the_jax_names():
    """Each port Example module has its counterpart in Examples/, which
    defines a class of the same name as the port's Trainer."""
    import importlib

    for module, port in example_trainers().items():
        ref = getattr(importlib.import_module(f"Examples.{module}"), port.__name__)
        assert isinstance(ref, type)


# ----------------------------------------------------------------------------
# CBCNN stage 2
# ----------------------------------------------------------------------------
def _cbcnn_kwargs(cfg):
    return dict(num_classes=int(cfg.num_classes), stage=int(cfg.stage),
                output_channel=int(cfg.output_channel), backbone_name=cfg.backbone)


class JaxF32CBCNNTrainer(JitInit, JaxCBCNNTrainer):
    def get_model(self, model_config):
        return JaxCBCNN(dtype=jnp.float32, **_cbcnn_kwargs(model_config))


class PortF32CBCNNTrainer(CBCNNTrainer):
    def get_model(self, model_config):
        return CBCNN(dtype=torch.float32, **_cbcnn_kwargs(model_config))


def test_cbcnn_stage2_step_matches_jax_example(tmp_path):
    path = _tiny_recipe_path("CBCNN_S2.yaml", tmp_path, {
        "model": {"load": None, "output_channel": 64}})
    jt = JaxF32CBCNNTrainer(jax_setup_config(argv=["--config", path]))
    pt = PortF32CBCNNTrainer(setup_config(argv=["--config", path]), device="cpu")
    load_jax_variables(pt.model, {"params": jax.device_get(jt.state.params)})
    assert int(pt.config.model.stage) == 2
    assert pt.config.train.optimizer.name == "SGD"
    one_step(jt, pt, _batch(0), lr=float(pt.config.train.optimizer.lr))
