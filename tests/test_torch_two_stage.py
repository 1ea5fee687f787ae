"""The port's two-stage BCNN chain through the real recipes in configs/,
on the CPU: stage 1 writes best_model, stage 2 loads it through the recipe's
``model.load`` key and trains, and a resumed stage 2 continues from the
checkpoint with the same weights, optimizer state and scheduler."""

import torch_threads  # noqa: F401  (PyTorch's thread count: see the module)
import os

import pytest
import torch
import yaml

import hawkeye_tpu_torch.models  # noqa: F401
from hawkeye_tpu_torch.config import setup_config
from hawkeye_tpu_torch.engine import Trainer

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "configs")


def _deep_merge(base, override):
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            _deep_merge(base[k], v)
        else:
            base[k] = v
    return base


def _tiny_recipe(name, tmp_path, overrides):
    with open(os.path.join(CONFIGS, name)) as f:
        recipe = yaml.safe_load(f)
    _deep_merge(recipe, {
        "experiment": {"log_dir": str(tmp_path), "debug": True},
        "dataset": {
            "name": "synthetic", "length": 8, "batch_size": 4,
            "num_workers": 0,
            "transformer": {"image_size": 64, "resize_size": 72},
        },
        "model": {"backbone": "vgg11", "num_classes": 4},
    })
    _deep_merge(recipe, overrides)
    recipe["dataset"].pop("root_dir", None)
    recipe["dataset"].pop("meta_dir", None)
    path = tmp_path / f"{len(os.listdir(tmp_path))}_{name}"
    with open(path, "w") as f:
        yaml.safe_dump(recipe, f)
    return setup_config(argv=["--config", str(path)])


def _state(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_bcnn_s1_s2_resume_chain(tmp_path):
    s1 = Trainer(_tiny_recipe("BCNN_S1.yaml", tmp_path, {"train": {"epoch": 1}}),
                 device="cpu")
    assert int(s1.config.model.stage) == 1
    s1.train()
    s1_best = os.path.join(s1.log_root, "best_model.pt")
    assert os.path.exists(s1_best), "stage 1 must write best_model"
    s1_state = _state(s1.model)

    # the recipe names the JAX package's best_model.msgpack; the port reads
    # the .pt file it wrote in its place
    s2_cfg = _tiny_recipe("BCNN_S2.yaml", tmp_path, {
        "model": {"load": os.path.join(s1.log_root, "best_model.msgpack"),
                  "fused_pooling": True},
        "train": {"epoch": 1, "save_frequence": 1}})
    s2 = Trainer(s2_cfg, device="cpu")
    assert int(s2.config.model.stage) == 2 and s2.config.train.val_first
    _assert_same(_state(s2.model), s1_state)
    s2.train()
    for f in ("best_model.pt", "model_epoch_0.pt", "checkpoint_epoch_0.pt"):
        assert os.path.exists(os.path.join(s2.log_root, f)), f
    assert s2.step == 2
    s2_state = _state(s2.model)
    assert not torch.equal(s2_state["backbone.features.0.weight"],
                           s1_state["backbone.features.0.weight"])

    # resume: weights, momentum buffers, scheduler and counters come back
    resumed = Trainer(_tiny_recipe("BCNN_S2.yaml", tmp_path, {
        "model": {"load": None, "fused_pooling": True},
        "experiment": {"resume": os.path.join(s2.log_root,
                                              "checkpoint_epoch_0.pt")},
        "train": {"epoch": 2}}), device="cpu")
    assert resumed.start_epoch == 1 and resumed.step == 2
    _assert_same(_state(resumed.model), s2_state)
    assert resumed.scheduler.state_dict() == s2.scheduler.state_dict()
    for (pa, pb) in zip(s2.model.parameters(), resumed.model.parameters()):
        assert torch.equal(s2.optimizer.state[pa]["momentum_buffer"],
                           resumed.optimizer.state[pb]["momentum_buffer"])
    resumed.train()
    assert resumed.step == 4
    assert os.path.exists(os.path.join(resumed.log_root, "checkpoint_epoch_1.pt"))


def test_emergency_save_writes_checkpoint_and_reraises(tmp_path):
    t = Trainer(_tiny_recipe("BCNN_S1.yaml", tmp_path, {"train": {"epoch": 1}}),
                device="cpu")

    def boom(lr):
        raise RuntimeError("boom")

    t.train_epoch = boom
    with pytest.raises(RuntimeError, match="boom"):
        t.train()
    assert os.path.exists(os.path.join(t.log_root, "checkpoint_epoch_0.pt"))


def test_train_entry_point_runs_a_recipe_on_cpu(tmp_path):
    from hawkeye_tpu_torch import train

    cfg = _tiny_recipe("BCNN_S1.yaml", tmp_path, {"train": {"epoch": 1}})
    path = tmp_path / "cli_S1.yaml"
    with open(path, "w") as f:
        f.write(cfg.dump())
    train.main(["--config", str(path), "--device", "cpu"])
    log_root = os.path.join(str(tmp_path), cfg.experiment.name)
    assert os.path.exists(os.path.join(log_root, "best_model.pt"))
    assert os.path.exists(os.path.join(log_root, "checkpoint_epoch_0.pt"))
