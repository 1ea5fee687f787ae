"""The port's Tester (hawkeye_tpu_torch/engine/tester.py) against the JAX
Tester on the CPU: the same top-1 from the same weights (the port's init,
carried to JAX by the bridge), with either
pipeline; and the port's Trainer with ``dataset.pipeline: device`` on its
own draws, whose best model the Tester reads back. The step against the
JAX Trainer is in test_torch_slice_resnet.py."""

import torch_threads  # noqa: F401  (PyTorch's thread count: see the module)
import functools
import os

import jax
import numpy as np
import pytest
import torch
import yaml

import hawkeye_tpu.models  # noqa: F401
import hawkeye_tpu_torch.models  # noqa: F401
from hawkeye_tpu.config import setup_config as jax_setup_config
from hawkeye_tpu.engine import Tester as JaxTester
from hawkeye_tpu.engine import checkpoint as jax_ckpt
from hawkeye_tpu_torch.config import setup_config
from hawkeye_tpu_torch.engine import Tester, Trainer
from hawkeye_tpu_torch.engine import checkpoint as ckpt
from hawkeye_tpu_torch.models import load_jax_variables
from hawkeye_tpu_torch.models.methods.baseline import BaselineClassifier
from test_torch_resnet import _with_stats, port_init

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "configs")


def _recipe(tmp_path, overrides):
    """configs/Baseline_synthetic.yaml with ``overrides``, written to disk."""
    with open(os.path.join(CONFIGS, "Baseline_synthetic.yaml")) as f:
        recipe = yaml.safe_load(f)
    for k, v in overrides.items():
        recipe[k] = {**recipe.get(k, {}), **v}
    recipe["experiment"].update(log_dir=str(tmp_path), debug=True)
    path = tmp_path / f"{len(os.listdir(tmp_path))}_recipe.yaml"
    with open(path, "w") as f:
        yaml.safe_dump(recipe, f)
    return str(path)


SLICE = {
    "dataset": {"length": 8, "batch_size": 8, "num_workers": 0, "num_classes": 5,
                "pipeline": "device",
                "transformer": {"image_size": 32, "resize_size": 40}},
    "model": {"name": "ResNet18", "num_classes": 5, "dtype": "float32"},
    "train": {"epoch": 1,
              "optimizer": {"name": "SGD", "lr": 0.05, "momentum": 0.9,
                            "weight_decay": 0.0001}},
}


def test_device_pipeline_trains_and_the_tester_reads_its_best_model(tmp_path):
    """The port alone, with its own draws: one epoch through the Trainer's
    device pipeline (TA-wide on), then the Tester on the saved best model
    gives the Trainer's last val accuracy."""
    over = {**SLICE, "dataset": {**SLICE["dataset"], "length": 16,
                                 "batch_size": 4}}
    path = _recipe(tmp_path, over)

    class Recording(Trainer):
        def report(self, epoch, lr, train_metrics, val_metrics, images_per_sec):
            self.last = (train_metrics, val_metrics)

    pt = Recording(setup_config(argv=["--config", path]), device="cpu")
    stats_before = pt.model.backbone.bn1.running_var.clone()
    pt.train()
    train_m, val_m = pt.last
    assert np.isfinite(train_m["loss"]) and train_m["count"] == 16
    assert not torch.equal(pt.model.backbone.bn1.running_var, stats_before)
    best = os.path.join(pt.log_root, "best_model.msgpack")
    assert os.path.exists(ckpt.port_path(best))

    test_cfg = {"dataset": {**over["dataset"], "length": 4},  # the val split
                "model": {**over["model"], "load": best}}
    acc = Tester(setup_config(argv=["--config", _recipe(tmp_path, test_cfg)]),
                 device="cpu").test()
    assert acc == val_m["acc"]


class _JitInit:
    """A flax module whose ``init`` runs as one compiled program: op by op, a
    cold process's first ResNet init takes ~10 s."""

    def __init__(self, module):
        self.module = module

    def init(self, rngs, x, **kw):
        return jax.jit(functools.partial(self.module.init, **kw))(rngs, x)

    def __getattr__(self, name):
        return getattr(self.module, name)


class JitInitTester(JaxTester):
    def get_model(self, model_config):
        return _JitInit(super().get_model(model_config))


@pytest.mark.parametrize("pipeline", ["host", "device"])
def test_tester_matches_jax_tester(tmp_path, pipeline):
    pm = BaselineClassifier("resnet18", 5, dtype=torch.float32)
    variables = _with_stats(port_init(pm, 4), 5)
    weights = str(tmp_path / "weights.msgpack")
    jax_ckpt.save_model(weights, variables)
    load_jax_variables(pm, variables)
    ckpt.save_model(weights, pm)  # weights.pt beside it

    path = _recipe(tmp_path, {
        "dataset": {"length": 20, "batch_size": 8, "num_workers": 0,
                    "num_classes": 5, "pipeline": pipeline,
                    "transformer": {"image_size": 32, "resize_size": 40}},
        "model": {"name": "ResNet18", "num_classes": 5, "dtype": "float32",
                  "load": weights}})
    want = JitInitTester(jax_setup_config(argv=["--config", path])).test()
    tester = Tester(setup_config(argv=["--config", path]), device="cpu")
    assert len(tester.dataset) == 20
    assert tester.test() == want
    # the weights do tell the images apart
    batch = tester.prepare_batch(next(iter(tester.dataloader)))
    with torch.no_grad():
        assert len(set(tester.model(batch["img"])["logits"].argmax(-1).tolist())) > 1
