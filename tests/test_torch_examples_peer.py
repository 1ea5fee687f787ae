"""The port's Peer-Learning Example trainer against the JAX package's
Examples/PeerLearning.py on the CPU: one stage-2 step of each on the same
synthetic host batch from bridged weights (two vgg11 BCNN peers, 32x32,
a 1x1 post-pool5 map, batch 8, the drop rate of the schedule's epoch 3),
with the tolerances of test_torch_examples.py, and the peers' correct
counts equal.

The peers' trunks run in float64 on both sides (their bilinear heads in
float32, in both packages): at batch 8 a float32 trunk puts Gram entries
within rounding of 0, where the signed square root's slope,
1/(2 sqrt(1e-5)), turns that rounding into ~1e-2 of a conv's gradient in
either package alone. SGD (lr 1.0) in place of the recipe's Adam, whose
first step divides each gradient by its magnitude plus 1e-8, so that
rounding decides the move of a parameter whose gradient is near 1e-8."""

import torch_threads  # noqa: F401  (PyTorch's thread count: see the module)
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch import nn

import hawkeye_tpu.models  # noqa: F401
import hawkeye_tpu_torch.models  # noqa: F401
from hawkeye_tpu.config import setup_config as jax_setup_config
from hawkeye_tpu.models.methods.bcnn import BCNN as JaxBCNN
from hawkeye_tpu.models.methods.peer_learning import PeerLearningNet as JaxPL
from hawkeye_tpu_torch.config import setup_config
from hawkeye_tpu_torch.examples.PeerLearning import PLTrainer
from hawkeye_tpu_torch.models.methods.bcnn import BCNN
from hawkeye_tpu_torch.models.methods.peer_learning import PeerLearningNet
from test_torch_examples import _batch, one_step
from test_torch_trainer import _tiny_recipe_path, from_port

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from Examples.PeerLearning import PLTrainer as JaxPLTrainer  # noqa: E402


# ----------------------------------------------------------------------------
def _peer_kwargs(cfg):
    base = cfg.base_model
    return dict(num_classes=int(base.num_classes), stage=int(base.stage),
                backbone_name=base.backbone)


class JaxF64PL(JaxPL):
    def setup(self):
        kw = dict(self.base_config)
        self.base_model = JaxBCNN(dtype=jnp.float64, **kw)
        self.base_model2 = JaxBCNN(dtype=jnp.float64, **kw)


class PortF64PL(PeerLearningNet):
    def __init__(self, **kw):
        nn.Module.__init__(self)
        self.base_model = BCNN(dtype=torch.float64, **kw)
        self.base_model2 = BCNN(dtype=torch.float64, **kw)


class JaxF64PLTrainer(JaxPLTrainer):
    def get_model(self, model_config):
        return JaxF64PL(base_config=_peer_kwargs(model_config))


class PortF64PLTrainer(PLTrainer):
    def get_model(self, model_config):
        return PortF64PL(**_peer_kwargs(model_config))


def test_peer_learning_stage2_step_matches_jax_example(tmp_path):
    path = _tiny_recipe_path("PeerLearning_BCNN_S2.yaml", tmp_path, {
        "dataset": {"length": 16, "batch_size": 8,
                    "transformer": {"image_size": 32, "resize_size": 36}},
        "model": {"num_classes": 4, "load": None,
                  "base_model": {"backbone": "vgg11", "num_classes": 4}},
        "train": {"epoch": 10, "optimizer": {"name": "SGD", "lr": 1.0,
                                             "momentum": 0.9}}})
    pt = PortF64PLTrainer(setup_config(argv=["--config", path]), device="cpu")
    with jax.enable_x64(True):
        jt = from_port(JaxF64PLTrainer, pt.model)(jax_setup_config(argv=["--config", path]))
    assert pt.rate_schedule.dtype == np.float32
    np.testing.assert_array_equal(pt.rate_schedule, jt.rate_schedule)
    jt.epoch = pt.epoch = 3  # a drop rate inside the ramp, 0.0833
    assert 0 < pt.rate_schedule[3] < float(pt.config.model.drop_rate)
    batch = _batch(1, n=8, size=32)
    assert pt.prepare_batch(batch, train=True)["drop_rate"] == float(
        pt.rate_schedule[3])
    assert "drop_rate" not in pt.prepare_batch(batch, train=False)
    with jax.enable_x64(True):
        one_step(jt, pt, batch, lr=float(pt.config.train.optimizer.lr),
                 keys=("correct", "correct1", "correct2"))
