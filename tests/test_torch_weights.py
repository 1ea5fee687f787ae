"""The port's pretrained-backbone loader (hawkeye_tpu_torch/models/
weights.py) against the JAX package's (hawkeye_tpu/models/weights.py) on
the CPU: a seeded state dict in torchvision's layout, written to a .pth in
the test's directory, loads into the port's backbone with exactly the
tensors that the JAX loader merges into the same variables (compared
through the bridge) and the same log lines; a missing file logs "training
from scratch" and keeps the init, in both; a .msgpack name reads the port's
.pt file of the same stem; and the port's Trainer reads
``model.backbone.pretrain`` (and ``model.pretrain``) as the JAX Trainer
does. No weight file is in the repository: every file here is made by the
test."""

import os
import re

import numpy as np
import pytest
import torch

import hawkeye_tpu_torch.models  # noqa: F401
from hawkeye_tpu.models.weights import convert_bbn_inat_resnet as jax_convert_bbn
from hawkeye_tpu.models.weights import load_pretrained_backbone as jax_load_pretrained
from hawkeye_tpu.models.weights import merge_into
from hawkeye_tpu_torch.config import setup_config
from hawkeye_tpu_torch.engine import checkpoint as ckpt
from hawkeye_tpu_torch.examples.ProtoTreeNet import ProtoTreeTrainer
from hawkeye_tpu_torch.models import export_jax_variables, init_parameters
from hawkeye_tpu_torch.models.methods.baseline import BaselineClassifier
from hawkeye_tpu_torch.models.weights import (
    convert_bbn_inat_resnet,
    load_pretrained_backbone,
)
from test_torch_resnet import _leaves
from test_torch_trainer import _tiny_recipe_path


class ListLogger:
    def __init__(self):
        self.lines = []

    def info(self, msg):
        self.lines.append(msg)


def torchvision_state_dict(model, seed, fc_classes=1000):
    """A seeded state dict under torchvision's names for the port's
    ``model`` (a ResNet or VGG trunk): ``layer1_0`` is ``layer1.0``,
    ``downsample_conv``/``_bn`` are ``downsample.0``/``.1``, BatchNorm
    carries ``num_batches_tracked``, and a ResNet an ImageNet ``fc``."""
    rs = np.random.RandomState(seed)
    sd = {}
    for k, v in model.state_dict().items():
        k = re.sub(r"^layer(\d+)_(\d+)\.", r"layer\1.\2.", k)
        k = k.replace("downsample_conv", "downsample.0").replace("downsample_bn",
                                                                 "downsample.1")
        arr = rs.randn(*v.shape).astype(np.float32)
        if k.endswith("running_var"):
            arr = np.abs(arr) + 0.5
        sd[k] = torch.from_numpy(arr)
        if k.endswith("running_var"):
            sd[k.replace("running_var", "num_batches_tracked")] = torch.tensor(7)
    if "conv1.weight" in sd:
        c = model.out_channels
        sd["fc.weight"] = torch.from_numpy(rs.randn(fc_classes, c).astype(np.float32))
        sd["fc.bias"] = torch.from_numpy(rs.randn(fc_classes).astype(np.float32))
    return sd


def _model(backbone="resnet18", seed=0):
    m = BaselineClassifier(backbone, 5, dtype=torch.float32)
    return init_parameters(m, torch.Generator().manual_seed(seed))


def _assert_trees_equal(got, want):
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], np.asarray(v, np.float32), err_msg=k)


@pytest.mark.parametrize("backbone,kind,wrap", [
    ("resnet18", "resnet", False), ("resnet18", "resnet", True),
    ("vgg11", "vgg", False)])
def test_pth_loads_the_tensors_the_jax_loader_merges(tmp_path, backbone, kind, wrap):
    pm = _model(backbone)
    sd = torchvision_state_dict(pm.backbone, 1)
    path = str(tmp_path / "weights.pth")
    # a training checkpoint's {"state_dict": {"module.<name>": ...}} unwraps
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}} if wrap
               else sd, path)
    variables = export_jax_variables(pm)
    jax_log, port_log = ListLogger(), ListLogger()
    want = jax_load_pretrained(variables, path, kind, logger=jax_log)
    report = load_pretrained_backbone(pm, path, kind, logger=port_log)
    _assert_trees_equal(export_jax_variables(pm), want)
    assert port_log.lines == jax_log.lines
    missing = 2 if kind == "resnet" else 0  # the ImageNet fc
    assert report["loaded"] == len([k for k in sd if "num_batches" not in k
                                    and not k.startswith("fc.")])
    assert len(report["skipped_missing"]) == missing
    assert jax_log.lines[0].startswith(f"partial load: {report['loaded']} tensors")


def test_shape_mismatch_is_skipped_and_reported_like_jax(tmp_path):
    pm = _model()
    sd = torchvision_state_dict(pm.backbone, 2)
    sd["layer4.1.conv2.weight"] = torch.zeros(3, 3, 3, 3)
    path = str(tmp_path / "w.pt")
    torch.save(sd, path)
    variables = export_jax_variables(pm)
    jax_log, port_log = ListLogger(), ListLogger()
    want = jax_load_pretrained(variables, path, "resnet", logger=jax_log)
    report = load_pretrained_backbone(pm, path, "resnet", logger=port_log)
    _assert_trees_equal(export_jax_variables(pm), want)
    assert report["skipped_shape"] == [
        "backbone.layer4_1.conv2.weight: (512, 512, 3, 3) vs (3, 3, 3, 3)"]
    assert jax_log.lines[0] == port_log.lines[0]
    assert "1 shape-mismatched" in port_log.lines[0]


def test_missing_file_logs_and_keeps_the_init(tmp_path):
    pm = _model()
    before = export_jax_variables(pm)
    path = str(tmp_path / "absent.pth")
    jax_log, port_log = ListLogger(), ListLogger()
    assert jax_load_pretrained(before, path, "resnet", logger=jax_log) is before
    assert load_pretrained_backbone(pm, path, "resnet", logger=port_log) is None
    _assert_trees_equal(export_jax_variables(pm), before)
    assert port_log.lines == jax_log.lines == [
        f"pretrained weights not found at {path!r}; training from scratch"]
    assert load_pretrained_backbone(pm, str(tmp_path / "absent.msgpack"),
                                    logger=port_log) is None


def test_msgpack_name_reads_the_port_file_into_the_whole_model(tmp_path):
    src, dst = _model(seed=3), _model(seed=4)
    ckpt.save_model(str(tmp_path / "inat.msgpack"), src)  # writes inat.pt
    assert os.listdir(tmp_path) == ["inat.pt"]
    report = load_pretrained_backbone(dst, str(tmp_path / "inat.msgpack"))
    assert not report["skipped_missing"] and not report["skipped_shape"]
    for k, v in src.state_dict().items():
        assert torch.equal(dst.state_dict()[k], v), k


def test_bbn_remap_matches_jax():
    """The BBN iNat remap (``cb_block`` is ``layer4.2``; ``rb_block`` and
    the classifier go), on the prefixed names the JAX converter reads."""
    trunk = _model("resnet50").backbone
    sd = torchvision_state_dict(trunk, 5)
    bbn = {}
    for k, v in sd.items():
        if k.startswith("fc."):
            bbn[f"module.classifier.{k[3:]}"] = v
        elif k.startswith("layer4.2."):
            bbn["module.backbone.cb_block." + k[len("layer4.2."):]] = v
            bbn["module.backbone.rb_block." + k[len("layer4.2."):]] = v * 2
        else:
            bbn[f"module.backbone.{k}"] = v
    flat_p, flat_s = jax_convert_bbn({k: v.numpy() for k, v in bbn.items()})
    model = _model("resnet50")
    want, _ = merge_into(export_jax_variables(model), flat_p, flat_s,
                         subpath=("backbone",))
    port = convert_bbn_inat_resnet(bbn)
    assert not any(k.startswith("fc.") for k in port)
    with torch.no_grad():
        for k, v in port.items():
            model.backbone.state_dict()[k].copy_(v)
    _assert_trees_equal(export_jax_variables(model), want)
    # the loader's stripped names remap the same way
    stripped = {k[len("module."):]: v for k, v in bbn.items()}
    assert convert_bbn_inat_resnet(stripped).keys() == port.keys()


def _prototree_recipe(tmp_path, model):
    return setup_config(argv=["--config", _tiny_recipe_path(
        "ProtoTreeNet.yaml", tmp_path, {"model": {"height": 3, "num_features": 16,
                                                  **model}})])


class QuietProtoTree(ProtoTreeTrainer):
    def get_tb_writer(self):
        return None


@pytest.mark.parametrize("key", ["backbone", "model"])
def test_trainer_loads_the_pretrained_backbone(tmp_path, key):
    trunk = _model().backbone
    sd = torchvision_state_dict(trunk, 6)
    path = str(tmp_path / "r18.pth")
    torch.save(sd, path)
    model = ({"backbone": {"name": "resnet18", "pretrain": path}} if key == "backbone"
             else {"backbone": {"name": "resnet18"}, "pretrain": path})
    tr = QuietProtoTree(_prototree_recipe(tmp_path, model), device="cpu")
    own = tr.model.backbone.state_dict()
    loaded = {k: v for k, v in sd.items()
              if "num_batches" not in k and not k.startswith("fc.")}
    for k, v in loaded.items():
        k = re.sub(r"^layer(\d+)\.(\d+)\.", r"layer\1_\2.", k)
        k = k.replace("downsample.0", "downsample_conv").replace("downsample.1",
                                                                 "downsample_bn")
        assert torch.equal(own[k], v), k
    with open(os.path.join(tr.log_root, "report.log")) as f:
        assert f"partial load: {len(loaded)} tensors loaded, 2 missing" in f.read()


def test_trainer_with_a_missing_pretrain_trains_from_scratch(tmp_path):
    absent = str(tmp_path / "model_weights" / "inat2017_resnet50.msgpack")
    tr = QuietProtoTree(_prototree_recipe(
        tmp_path, {"backbone": {"name": "resnet18", "pretrain": absent}}), device="cpu")
    ref = QuietProtoTree(_prototree_recipe(
        tmp_path, {"backbone": {"name": "resnet18"}}), device="cpu")
    for k, v in ref.model.state_dict().items():
        assert torch.equal(tr.model.state_dict()[k], v), k
    with open(os.path.join(tr.log_root, "report.log")) as f:
        assert (f"pretrained weights not found at {absent!r}; training from scratch"
                in f.read())
