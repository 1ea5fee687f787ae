"""The port's S3N and MGE_CNN Example trainers against the JAX package's
Examples/S3N.py and Examples/MGE_CNN.py on the CPU, as
test_torch_examples_osme_apinet.py sets out: the JAX trainer starts from
the port's perturbed init through the bridge (``example_pair``, so no JAX
init compiles), one step of each trainer through its own train step on the
same host batch, the tolerances of test_torch_examples.py; one-block-per-
stage trunks (``TINY``: the trainers' wiring does not depend on the depth,
and test_torch_s3n_mge.py holds the models at resnet18 depth), 64x64, batch
8 (the JAX trainer's 8 CPU devices).

S3N, in float64 throughout (test_torch_s3n_mge.py says why and patches the
JAX module so): the recipe's SGD with its three groups (classifiers 1x, the
radii and the blur kernel 1e-5x, the rest 0.1x) at 50x the recipe's LR (a
step that moves the weights visibly); both trainers' phases at epochs 0,
19, 20 and 99; a step at epoch 0 (phase 0, on each model's own class map
through its entropy gate) and one at epoch 20 (phase 1, on fixed draws,
which the port's model takes where it would draw from the trainer's
``model_generator``, and SCORE's many peaks): the loss, every update, the
running statistics within 1e-6 and the peak masks identical. Then the
port's validation at phase 2 (epoch 20) and at phase 1 (epoch 0), on a
generator seeded 0 for every batch (two validations give the same loss).
MGE-CNN, its trunks in float64: SGD in place of the recipe's Adam (Adam's
first step would amplify the float32 heads' rounding), the backbones at
``lr_rate`` 0.1 and the heads at 1x, a step whose CAMs follow the labels:
the loss, every update, the running statistics within 1e-6 and the crop
boxes identical.

Then each recipe through the port alone, as chip_smoke.py's slice phase
drives it at full size, with the small models in float32: one epoch with
validation, the Tester on the best model (top-1 equal to the trained
model's at the Tester's call, S3N's phase 0; logits equal to the trained
model's).
"""

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
from hawkeye_tpu.models.methods import mge as jax_mge
from hawkeye_tpu.models.methods import s3n as jax_s3n
from hawkeye_tpu_torch.config import setup_config
from hawkeye_tpu_torch.engine import Tester
from hawkeye_tpu_torch.examples.MGE_CNN import MGETrainer
from hawkeye_tpu_torch.examples.S3N import S3NTrainer
from hawkeye_tpu_torch.losses.mge import MGELoss
from hawkeye_tpu_torch.losses.s3n import MultiSmoothLoss
from hawkeye_tpu_torch.models.methods import mge
from hawkeye_tpu_torch.models.methods.mge import MGECNN
from hawkeye_tpu_torch.models.methods.s3n import S3N
from test_torch_examples import _batch, one_step
from test_torch_examples_osme_apinet import NoTensorBoard, example_pair
from test_torch_region_ops import stats64
from test_torch_resnet import TINY, _assert_close_scaled
from test_torch_resnet import tiny_trunk  # noqa: F401  (a fixture: pytestmark)
from test_torch_s3n_mge import (U, float64_jax_s3n, jax_masks, port_masks, recorded_peaks,
                            with_many_peaks)
from test_torch_trainer import _tiny_recipe_path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from Examples.MGE_CNN import MGETrainer as JaxMGETrainer  # noqa: E402
from Examples.S3N import S3NTrainer as JaxS3NTrainer  # noqa: E402

pytestmark = pytest.mark.usefixtures("tiny_trunk")

KW = dict(num_classes=4, image_size=64, backbone_name=TINY)


class JaxF64S3NTrainer(JaxS3NTrainer):
    def get_model(self, model_config):
        return jax_s3n.S3N(dtype=jnp.float64, **KW)


class PortF64S3NTrainer(S3NTrainer):
    """Cast to float64 by the test after the trainer's init (float64 draws
    take ~3x as long, and the JAX trainer starts from float32 values)."""

    def get_model(self, model_config):
        return S3N(dtype=torch.float64, **KW)


def _recorded_calls(model):
    """Records the phase and the generator of each call of ``model``."""
    calls = []
    real = model.forward

    def forward(x, p=0, generator=None, u=None):
        calls.append((model.training, p, generator))
        return real(x, p=p, generator=generator, u=u)

    model.forward = forward
    return calls


@pytest.mark.parametrize("epoch", [0, 20], ids=["epoch0", "epoch20"])
def test_s3n_step_groups_and_phases_match_jax_example(tmp_path, monkeypatch, epoch):
    """A step of both trainers in float64 throughout (test_torch_s3n_mge.py's
    patches of the JAX module) at epoch 0 (phase 0, each model's own class
    map) or 20 (phase 1, on U's draws and SCORE's peaks): the loss, every
    update, the running statistics within 1e-6 of their largest value and
    the peak masks identical; at epoch 20 the port's validations too."""
    seen_jax = []
    float64_jax_s3n(monkeypatch, seen_jax)
    jt, pt = example_pair(tmp_path, JaxF64S3NTrainer, PortF64S3NTrainer, "S3N.yaml", {}, 50)
    pt.model.double()  # (its parameters stay the optimizer's)
    with jax.enable_x64(True):  # the JAX trainer's variables in float64 too
        jt.variables = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), jt.variables)
        jt.state = jt.create_state()
    if epoch == 20:
        with_many_peaks(monkeypatch, pt.model)
    opt = pt.config.train.optimizer
    assert opt.name == "SGD" and isinstance(pt.criterion, MultiSmoothLoss)
    assert pt.criterion.smooth_ratio == 0.85
    groups = {g["label"]: g for g in pt.optimizer.param_groups}
    assert {k: g["lr_mult"] for k, g in groups.items()} == {"cls": 1.0, "slow": 1e-5,
                                                             "base": 0.1}
    names = {id(p): n for n, p in pt.model.named_parameters()}
    assert {names[id(p)] for p in groups["slow"]["params"]} == {
        "radius.scale", "radius_inv.scale", "blur_kernel"}
    assert {names[id(p)].split(".")[0] for p in groups["cls"]["params"]} == {
        "raw_classifier", "sampler_classifier", "sampler_classifier1", "con_classifier"}
    for e in (0, 19, 20, 99):
        jt.epoch = pt.epoch = e
        assert (pt.train_phase(), pt.eval_phase()) == (jt.train_phase(), jt.eval_phase())

    jt.epoch = pt.epoch = epoch
    drawn = []

    def fixed_draws(generator, b):
        drawn.append(generator)
        return torch.from_numpy(U[:b])

    pt.model.uniform_draws = fixed_draws
    seen = recorded_peaks(pt.model)
    calls = _recorded_calls(pt.model)
    lr = float(opt.lr) * 50  # a step that moves the weights visibly
    with jax.enable_x64(True):
        one_step(jt, pt, _batch(51, n=8, size=64), lr=lr)
        _assert_close_scaled(stats64(pt.model), jax.device_get(jt.state.batch_stats),
                             rtol=0, scale_tol=1e-6)
    assert port_masks(seen) == jax_masks(seen_jax)
    assert {g["label"]: g["lr"] for g in pt.optimizer.param_groups} == {
        "cls": lr, "slow": 1e-5 * lr, "base": 0.1 * lr}
    zoom, inv = seen[0]
    assert [(t, p) for t, p, _ in calls] == [(True, epoch // 20)]
    if epoch == 0:  # one mask of the class map's peaks for both views
        assert torch.equal(zoom, inv) and zoom.sum() >= 8 and drawn == []
        return
    assert (zoom ^ inv).any() and (zoom | inv).sum() >= 80  # SCORE's peaks split
    assert drawn == [pt._model_generator]

    # validation: phase 2 at epoch 20, phase 1 at epoch 0 on a generator
    # seeded 0 for every batch
    val = pt.prepare_batch(_batch(53, n=8, size=64), train=False)
    pt.eval_step_call(val)
    pt.epoch = 0
    first, second = (float(pt.eval_step_call(val)["loss"]) for _ in range(2))
    assert first == second
    assert [(t, p) for t, p, _ in calls] == [(True, 1), (False, 2), (False, 1), (False, 1)]
    assert calls[0][2] is pt._model_generator
    assert calls[2][2] is calls[3][2] is pt._eval_generator
    assert drawn[1:] == [pt._eval_generator] * 2


class JaxF64MGETrainer(JaxMGETrainer):
    def get_model(self, model_config):
        return jax_mge.MGECNN(dtype=jnp.float64, **KW)


class PortF64MGETrainer(MGETrainer):
    """Its trunks cast to float64 by ``f64_trunks`` after the trainer's init
    (as ``PortF64S3NTrainer``)."""

    def get_model(self, model_config):
        return MGECNN(dtype=torch.float64, **KW)


def f64_trunks(model):
    for i in range(3):
        getattr(model, f"expert_{i}").backbone.to(torch.float64)
    model.gate_backbone.to(torch.float64)


def test_mge_step_and_groups_match_jax_example(tmp_path, monkeypatch):
    """A train step, whose CAMs follow the labels: the loss, every update,
    the running statistics within 1e-6 of their largest value and the two
    crop boxes of each image identical."""
    from test_torch_s3n_mge import _recording_cam_bbox, _recording_crop

    seen_jax, seen = [], []
    monkeypatch.setattr(jax_mge, "crop_resize_bilinear", _recording_crop(seen_jax))
    monkeypatch.setattr(mge, "cam_bbox", _recording_cam_bbox(seen))
    sgd = {"name": "SGD", "lr": 0.05, "momentum": 0.9, "weight_decay": 2e-5}
    jt, pt = example_pair(tmp_path, JaxF64MGETrainer, PortF64MGETrainer, "MGE_CNN.yaml",
                          {"train": {"optimizer": sgd}}, 54)
    f64_trunks(pt.model)
    assert isinstance(pt.criterion, MGELoss) and pt.criterion.label_smoothing == 0.1
    groups = {g["label"]: g for g in pt.optimizer.param_groups}
    assert {k: g["lr_mult"] for k, g in groups.items()} == {"extractor": 0.1,
                                                             "classifier": 1.0}
    names = {id(p): n for n, p in pt.model.named_parameters()}
    assert {".".join(names[id(p)].split(".")[:2]) for p in groups["extractor"]["params"]
            if not names[id(p)].startswith("gate")} == {
        f"expert_{i}.backbone" for i in range(3)}
    assert all(".head." in names[id(p)] or names[id(p)].startswith("cls_gate")
               for p in groups["classifier"]["params"])
    batch = _batch(55, n=8, size=64)
    with jax.enable_x64(True):
        one_step(jt, pt, batch, lr=0.05)
        _assert_close_scaled(stats64(pt.model), jax.device_get(jt.state.batch_stats),
                             rtol=0, scale_tol=1e-6)
    np.testing.assert_array_equal(np.stack(seen), np.stack(seen_jax))
    assert len(seen) == 2
    assert {g["label"]: g["lr"] for g in pt.optimizer.param_groups} == {
        "extractor": 0.1 * 0.05, "classifier": 0.05}


# the port-only runs' models: float32 and small (a bfloat16 trunk is slow on
# the CPU); the recipes' own models at full width are built by
# test_torch_package.py
PORT_MODELS = {"S3N.yaml": lambda: S3N(dtype=torch.float32, **KW),
               "MGE_CNN.yaml": lambda: MGECNN(dtype=torch.float32, **KW)}


def _tester_top1(model, loader, prepare):
    correct = count = 0
    with torch.no_grad():
        for batch in loader:
            b = prepare(batch, train=False)
            correct += int((model.eval()(b["img"])["logits"].argmax(-1) == b["label"]).sum())
            count += len(b["label"])
    return 100.0 * correct / count


@pytest.mark.parametrize("recipe,trainer_cls", [("S3N.yaml", S3NTrainer),
                                                ("MGE_CNN.yaml", MGETrainer)],
                         ids=["s3n", "mge"])
def test_recipe_trains_and_tests_through_the_port(tmp_path, recipe, trainer_cls):
    """One epoch of the recipe through the port at test size, then the
    Tester on its best model."""
    def get_model(self, model_config):
        return PORT_MODELS[recipe]()

    over = {"model": {"num_classes": 4}, "train": {"epoch": 1, "val_first": False}}
    cfg = setup_config(argv=["--config", _tiny_recipe_path(recipe, tmp_path, over)])
    tr = type("Port", (NoTensorBoard, trainer_cls), {"get_model": get_model})(
        cfg, device="cpu")
    tr.train()
    assert tr.step == 2
    val = tr.prepare_batch(next(iter(tr.dataloaders["val"])), train=False)
    with torch.no_grad():
        logits = tr.model.eval()(val["img"])["logits"]
    top1 = _tester_top1(tr.model, tr.dataloaders["val"], tr.prepare_batch)
    best = os.path.join(tr.log_root, "best_model.msgpack")
    tester = type("PortTester", (Tester,), {"get_model": get_model})(
        setup_config(argv=["--config", _tiny_recipe_path(recipe, tmp_path, {
            **over, "dataset": {"length": len(tr.datasets["val"])},
            "model": {"load": best}})]), device="cpu")
    assert tester.test() == top1
    with torch.no_grad():
        assert torch.equal(tester.model(val["img"])["logits"], logits)
