"""The slice as a whole: the port's Trainer (hawkeye_tpu_torch/engine)
against the JAX package's Trainer on the same tiny BCNN recipe (vgg11,
synthetic data, 64 px, batch 4), float32 on both sides, the JAX trainer
starting from the port's init through the bridge (``from_port``, so no JAX
init runs). One stage-2 step and two stage-1 steps go through each
trainer's own train step on the same host batch; the loss must agree to
rtol 1e-4 and every parameter's update (new - old) to rtol 1e-3, with an
atol of 1e-3 of the tensor's largest update (float32 summation order) plus
four float32 ulps of the parameter (the rounding of new and old)."""

import torch_threads  # noqa: F401  (PyTorch's thread count: see the module)
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import hawkeye_tpu.models  # noqa: F401
import hawkeye_tpu_torch.models  # noqa: F401
from hawkeye_tpu.config import setup_config as jax_setup_config
from hawkeye_tpu.engine import Trainer as JaxTrainer
from hawkeye_tpu.models.methods.bcnn import BCNN as JaxBCNN
from hawkeye_tpu_torch.config import setup_config
from hawkeye_tpu_torch.engine import Trainer
from hawkeye_tpu_torch.models import export_jax_variables, load_jax_variables
from hawkeye_tpu_torch.models.methods.bcnn import BCNN as PortBCNN

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "configs")


def _deep_merge(base, override):
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            _deep_merge(base[k], v)
        else:
            base[k] = v
    return base


def _tiny_recipe_path(name, tmp_path, overrides):
    """A real recipe from configs/, shrunk to test scale, written to disk
    for the --config CLI path."""
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
    return str(path)


def _model_kwargs(cfg):
    return dict(num_classes=int(cfg.num_classes), stage=int(cfg.stage),
                backbone_name=cfg.backbone,
                fused_pooling=bool(cfg.get("fused_pooling", False)))


class JaxF32Trainer(JaxTrainer):
    def get_model(self, model_config):
        return JaxBCNN(dtype=jnp.float32, **_model_kwargs(model_config))


class PortF32Trainer(Trainer):
    def get_model(self, model_config):
        return PortBCNN(dtype=torch.float32, **_model_kwargs(model_config))


def _batch(seed):
    rs = np.random.RandomState(seed)
    return {"img": rs.randn(4, 64, 64, 3).astype(np.float32),
            "label": np.array([0, 3, 1, 3], np.int64)}


def _assert_updates_close(port_before, port_after, jax_before, jax_after):
    flat = {}
    for name, tree in (("pb", port_before), ("pa", port_after),
                       ("jb", jax_before), ("ja", jax_after)):
        flat[name] = {str(k): np.asarray(v) for k, v in
                      jax.tree_util.tree_leaves_with_path(tree)}
    assert flat["pa"].keys() == flat["ja"].keys()
    for k in flat["ja"]:
        np.testing.assert_allclose(flat["pb"][k], flat["jb"][k], rtol=0, atol=0)
        want = flat["ja"][k] - flat["jb"][k]
        got = flat["pa"][k] - flat["pb"][k]
        scale = float(np.abs(want).max()) or 1.0
        # (the port's export is float32, whatever the JAX parameters' dtype)
        tol = (1e-3 * np.abs(want) + 1e-3 * scale
               + 4 * np.spacing(np.abs(flat["jb"][k]).astype(np.float32)))
        bad = np.abs(got - want) > tol
        assert not bad.any(), (k, got[bad][:5], want[bad][:5])


def from_port(jax_cls, model):
    """``jax_cls`` whose initial variables are the port ``model``'s, through
    the bridge: no JAX init compiles. The model takes them back, so a
    parameter initialised in float64 holds the same float32 value as JAX's."""
    variables = export_jax_variables(model)
    load_jax_variables(model, variables)
    return type(jax_cls.__name__, (jax_cls,),
                {"init_model_variables": lambda self: variables})


def _pair(tmp_path, name, overrides):
    path = _tiny_recipe_path(name, tmp_path, overrides)
    pt = PortF32Trainer(setup_config(argv=["--config", path]), device="cpu")
    jt = from_port(JaxF32Trainer, pt.model)(jax_setup_config(argv=["--config", path]))
    return jt, pt


def _steps(jt, pt, batches, lr):
    jax_before = jax.device_get(jt.state.params)
    port_before = export_jax_variables(pt.model)["params"]
    losses = []
    for batch in batches:
        jt.state, mj = jt.train_step_call(jt.prepare_batch(batch, train=True),
                                          jnp.asarray(lr, jnp.float32))
        mp = pt.train_step_call(pt.prepare_batch(batch, train=True), lr)
        losses.append((float(mp["loss"]), float(mj["loss"])))
        assert float(mp["count"]) == float(mj["count"]) == 4.0
        assert float(mp["correct"]) == float(mj["correct"])
    _assert_updates_close(port_before, export_jax_variables(pt.model)["params"],
                          jax_before, jax.device_get(jt.state.params))
    for got, want in losses:
        np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("fused", [False, True], ids=["plain_head", "fused_head"])
def test_stage2_step_matches_jax_trainer(tmp_path, fused):
    jt, pt = _pair(tmp_path, "BCNN_S2.yaml",
                   {"model": {"load": None, "fused_pooling": fused}})
    assert int(pt.config.model.stage) == 2
    _steps(jt, pt, [_batch(0)], lr=float(pt.config.train.optimizer.lr))


def test_stage1_frozen_backbone_decays_like_jax(tmp_path):
    # weight decay raised from the recipe's 1e-8 so that its move of the
    # frozen backbone (g = 0 + wd*p, then momentum) is far above rounding
    jt, pt = _pair(tmp_path, "BCNN_S1.yaml",
                   {"train": {"optimizer": {"weight_decay": 0.01}}})
    assert int(pt.config.model.stage) == 1
    conv = pt.model.backbone.features["3"].weight
    before = conv.detach().clone()
    _steps(jt, pt, [_batch(1), _batch(2)], lr=0.1)
    # two steps of decay with momentum: p * (1 - lr*wd*(1 + (1 + 0.9)))
    assert torch.allclose(conv.detach(), before * (1 - 0.1 * 0.01 * 2.9),
                          rtol=1e-5, atol=0)


def test_validation_weighting_matches_jax_trainer(tmp_path):
    """Validation with a partial last batch: the JAX trainer pads it with
    weight-0 rows, the port does not pad; loss (mean of per-batch means) and
    accuracy must agree. Also: the port's Trainer turns TF32 off."""
    jt, pt = _pair(tmp_path, "BCNN_S2.yaml",
                   {"model": {"load": None},
                    "dataset": {"length": 24}})  # val: 6 images -> 4 + 2
    assert [len(b["label"]) for b in pt.dataloaders["val"]] == [4, 2]
    want, got = jt.validate(), pt.validate()
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    assert got["acc"] == want["acc"]
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
