"""The third slice's two-stage flows on the CPU, the port alone, through
its Example trainers and the recipes in configs/ (vgg11, 64x64): CBCNN
S1 -> S2 -> the Tester, with no sketch or irDFT tensor in any ``.pt`` it
writes, and Peer-Learning S1 -> S2 with the acc1/acc2 meters filled and
the peer log line."""

import torch_threads  # noqa: F401  (PyTorch's thread count: see the module)
import os

import numpy as np
import torch

import hawkeye_tpu_torch.models  # noqa: F401
from hawkeye_tpu_torch.config import setup_config
from hawkeye_tpu_torch.engine import Tester
from hawkeye_tpu_torch.examples.CBCNN import CBCNNTrainer
from hawkeye_tpu_torch.examples.PeerLearning import PLTrainer
from test_torch_trainer import _tiny_recipe_path


def _stage(tmp_path, cls, name, overrides, loads=None):
    """One stage through an Example trainer; ``loads``: the state dict
    ``model.load`` must have filled the model with."""
    cfg = setup_config(argv=["--config", _tiny_recipe_path(name, tmp_path, overrides)])

    class Recording(cls):
        def report(self, epoch, lr, train_metrics, val_metrics, images_per_sec):
            self.last = (train_metrics, val_metrics)

    trainer = Recording(cfg, device="cpu")
    if loads is not None:
        state = trainer.model.state_dict()
        assert state.keys() == loads.keys()
        assert all(torch.equal(state[k], v) for k, v in loads.items())
    trainer.train()
    return trainer


def _state(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def test_cbcnn_two_stages_then_the_tester(tmp_path):
    over = {"model": {"output_channel": 64}, "train": {"epoch": 1},
            "dataset": {"length": 16}}
    s1 = _stage(tmp_path, CBCNNTrainer, "CBCNN_S1.yaml", over)
    assert int(s1.config.model.stage) == 1
    best1 = os.path.join(s1.log_root, "best_model.msgpack")  # the recipe's name
    s2 = _stage(tmp_path, CBCNNTrainer, "CBCNN_S2.yaml",
                {**over, "model": {"output_channel": 64, "load": best1}},
                loads=_state(s1.model))
    assert s2.step == 4
    best2 = os.path.join(s2.log_root, "best_model.msgpack")
    for root in (s1.log_root, s2.log_root):
        for f in os.listdir(root):
            if f.endswith(".pt"):
                state = torch.load(os.path.join(root, f), weights_only=True)
                state = state.get("model", state)
                bad = [k for k in state if k.startswith(("sketch", "spectrum", "irdft"))]
                assert not bad and "fc.weight" in state, (f, bad)
    tester = Tester(setup_config(argv=["--config", _tiny_recipe_path(
        "CBCNN_S2.yaml", tmp_path, {**over, "dataset": {"length": 4},
                                    "model": {"output_channel": 64, "load": best2}})]),
        device="cpu")
    assert tester.test() == s2.last[1]["acc"]
    val = s2.prepare_batch(next(iter(s2.dataloaders["val"])), train=False)
    with torch.no_grad():
        assert torch.equal(tester.model(val["img"])["logits"],
                           s2.model.eval()(val["img"])["logits"])
    # the constants are rebuilt at construction, not read from the file
    assert torch.equal(tester.model.irdft_cos, s2.model.irdft_cos)


def test_peer_learning_two_stages(tmp_path):
    base = {"backbone": "vgg11", "num_classes": 4}
    s1 = _stage(tmp_path, PLTrainer, "PeerLearning_BCNN_S1.yaml",
                {"model": {"num_classes": 4, "T_k": 2, "base_model": base},
                 "train": {"epoch": 2}})
    np.testing.assert_array_equal(s1.rate_schedule, np.float32([0.0, 0.25]))
    assert len(s1.performance_meters["train"]["acc1"].values) == 2
    s1_state = _state(s1.model)
    assert {k.split(".")[0] for k in s1_state} == {"base_model", "base_model2"}
    best = os.path.join(s1.log_root, "best_model.msgpack")  # the recipe's name
    s2 = _stage(tmp_path, PLTrainer, "PeerLearning_BCNN_S2.yaml",
                {"model": {"num_classes": 4, "load": best,
                           "base_model": {**base, "fused_pooling": True}},
                 "train": {"epoch": 1}}, loads=s1_state)
    assert s2.model.base_model.fused_pooling and s2.model.base_model2.fused_pooling
    # stage 2 fine-tunes both nested trunks
    for peer in ("base_model", "base_model2"):
        w = f"{peer}.backbone.features.0.weight"
        assert not torch.equal(s2.model.state_dict()[w], s1_state[w])
    for k in ("acc1", "acc2"):
        values = s2.performance_meters["train"][k].values
        assert len(values) == 1 and 0.0 <= values[0] <= 100.0
    with open(os.path.join(s2.log_root, "report.log")) as f:
        assert "Epoch 0: peer acc1" in f.read()
