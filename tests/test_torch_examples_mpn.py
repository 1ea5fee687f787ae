"""The port's MPN Example trainer against the JAX package's
Examples/MPN.py on the CPU: one step of each on the same synthetic host
batch from the port's init (``from_port``), resnet18 trunks at 96x96 with
``dimension_reduction`` 16 (a 3x3 ``c5`` map), batch 8, float64 trunks and
SGD, as test_torch_examples_resnet.py sets out; the tolerances of
test_torch_examples.py. SGD also shows the parameter groups in the
updates: the backbone moves at 0.2x the LR of the reduction, its BatchNorm
and the classifier."""

import torch_threads  # noqa: F401  (PyTorch's thread count: see the module)
import os
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

import hawkeye_tpu.models  # noqa: F401
import hawkeye_tpu_torch.models  # noqa: F401
from hawkeye_tpu.models.methods.mpn import MPN as JaxMPN
from hawkeye_tpu_torch.examples.MPN import MPNTrainer
from hawkeye_tpu_torch.models.methods.mpn import MPN
from test_torch_examples import _batch, one_step
from test_torch_examples_resnet import _pair
from test_torch_resnet import TINY
from test_torch_resnet import tiny_trunk  # noqa: F401  (a fixture: pytestmark)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from Examples.MPN import MPNTrainer as JaxMPNTrainer  # noqa: E402

pytestmark = pytest.mark.usefixtures("tiny_trunk")


class JaxF64MPNTrainer(JaxMPNTrainer):
    def get_model(self, model_config):
        return JaxMPN(num_classes=4, backbone_name=TINY,
                      dimension_reduction=16, dtype=jnp.float64)


class PortF64MPNTrainer(MPNTrainer):
    def get_model(self, model_config):
        model = MPN(num_classes=4, backbone_name=TINY,
                    dimension_reduction=16, dtype=torch.float64)
        model.backbone.to(torch.float64)  # the float32 head reads float32
        model.dr_bn.to(torch.float64)
        return model


def test_mpn_step_and_param_groups_match_jax_example(tmp_path):
    jt, pt = _pair(tmp_path, JaxF64MPNTrainer, PortF64MPNTrainer, "MPN.yaml", {
        "model": {"num_classes": 4},
        "train": {"optimizer": {"name": "SGD", "lr": 0.05, "momentum": 0.9}}})
    groups = {g["label"]: g for g in pt.optimizer.param_groups}
    assert set(groups) == {"backbone", "head"}
    assert groups["backbone"]["lr_mult"] == 0.2 and groups["head"]["lr_mult"] == 1.0
    backbone = {id(p) for p in pt.model.backbone.parameters()}
    assert {id(p) for p in groups["backbone"]["params"]} == backbone
    head = [n for n, p in pt.model.named_parameters() if id(p) not in backbone]
    assert sorted(head) == ["dr_bn.bias", "dr_bn.weight", "dr_conv.weight",
                            "fc.bias", "fc.weight"]
    assert len(groups["head"]["params"]) == len(head)
    with jax.enable_x64(True):
        one_step(jt, pt, _batch(2, n=8, size=96), lr=0.05)
    assert groups["backbone"]["lr"] == 0.2 * 0.05 and groups["head"]["lr"] == 0.05
