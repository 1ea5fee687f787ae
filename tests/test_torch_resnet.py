"""The port's BatchNorm, ResNet family, Baseline registrations and weight
bridge (hawkeye_tpu_torch/models) against the JAX package at small size,
float32 on both sides, with the variables (parameters and batch
statistics) carried across by the bridge: the port's init
(``port_init``, so that no JAX init runs) for the eval and stem
comparisons, the JAX init for the bridge's round trip. Eval-mode stage dicts rtol 1e-4 /
atol 1e-5; BatchNorm alone rtol 1e-5. One train step is in
``test_torch_resnet_train.py``.

The running statistics the eval tests read are mild (mean ~0.1, variance
0.8-1.25): statistics fitted to a small batch leave channels with a tiny
variance, whose division amplifies float32 rounding beyond any tolerance in
both packages alike."""

import torch_threads  # noqa: F401  (PyTorch's thread count: see the module)
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hawkeye_tpu.models  # noqa: F401
import hawkeye_tpu_torch.models  # noqa: F401
from hawkeye_tpu.config import ConfigNode as JaxConfigNode
from hawkeye_tpu.models.methods.baseline import BaselineClassifier as JaxBaseline
from hawkeye_tpu.registry import BACKBONE as JAX_BACKBONE
from hawkeye_tpu.registry import MODEL as JAX_MODEL
from hawkeye_tpu_torch import BACKBONE, MODEL
from hawkeye_tpu_torch.config import ConfigNode
from hawkeye_tpu_torch.models import (
    export_jax_variables,
    init_parameters,
    load_jax_variables,
)
from hawkeye_tpu_torch.models.backbones.norm import BatchNorm
from hawkeye_tpu_torch.models.backbones.resnet import feature_dim
from hawkeye_tpu_torch.models.methods.baseline import BaselineClassifier

NAMES = ["resnet18", "resnet50", "resnext50_32x4d"]

# A BasicBlock ResNet with one block per stage (ResNet-18's widths and
# strides, half its depth), for the comparisons whose path runs a trunk but
# does not depend on its depth: the trunk itself is held against JAX at its
# registered depths in this file and test_torch_resnet_train.py, and the
# S3N and MGE-CNN models on resnet18 in test_torch_s3n_mge.py. A test that
# builds it asks for the ``tiny_trunk`` fixture, which registers it in both
# packages' BACKBONE for that test module alone.
TINY = "resnet10"


def _jax_tiny(num_classes=0, **kw):
    from hawkeye_tpu.models.backbones import resnet as jax_resnet

    return jax_resnet.ResNet(block_cls=jax_resnet.BasicBlock, stage_sizes=(1, 1, 1, 1),
                             num_classes=num_classes, **kw)


def _port_tiny(num_classes=0, **kw):
    from hawkeye_tpu_torch.models.backbones import resnet

    return resnet.ResNet(resnet.BasicBlock, (1, 1, 1, 1), num_classes=num_classes, **kw)


@pytest.fixture(scope="module")
def tiny_trunk():
    """``TINY`` in both packages' BACKBONE while the module's tests run."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(JAX_BACKBONE, TINY, _jax_tiny)
        mp.setitem(BACKBONE, TINY, _port_tiny)
        yield TINY


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


def init_in_float32(pm, seed):
    """``init_parameters`` of ``pm`` from ``seed``, its float64 tensors drawn
    in float32 and cast back: the variables a comparison hands to JAX are
    float32 whatever the model holds, and float64 draws take ~3x as long on
    the CPU (a ResNet-50: 6.5 s against 2.1 s)."""
    wide = [t for t in (*pm.parameters(), *pm.buffers()) if t.dtype == torch.float64]
    for t in wide:
        t.data = t.data.float()
    init_parameters(pm, torch.Generator().manual_seed(seed))
    for t in wide:
        t.data = t.data.double()
    return pm


def port_init(pm, seed):
    """The port model ``pm`` initialised by the port (``init_in_float32``
    from ``seed``), in the flax layout: the variables a comparison hands to
    the JAX model, so that no JAX init runs (op by op, a process's first JAX
    init of a ResNet compiles each primitive: ~10-20 s on the CPU). The model
    takes them back, so a parameter it holds in float64 has the float32 value
    JAX reads."""
    init_in_float32(pm, seed)
    variables = export_jax_variables(pm)
    load_jax_variables(pm, variables)
    return variables


def _with_stats(variables, seed):
    """The variables with mild random running statistics."""
    rs = np.random.RandomState(seed)

    def draw(path, a):
        if jax.tree_util.keystr(path).endswith("['var']"):
            return rs.uniform(0.8, 1.25, a.shape).astype(np.float32)
        return (rs.randn(*a.shape) * 0.1).astype(np.float32)

    variables = jax.device_get(variables)
    return {**variables, "batch_stats": jax.tree_util.tree_map_with_path(
        draw, variables["batch_stats"])}


def _port_grads(module):
    """Parameter gradients in the flax layout."""
    saved = {n: p.detach().clone() for n, p in module.named_parameters()}
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(p.grad)
    tree = export_jax_variables(module)["params"]
    with torch.no_grad():
        for n, p in module.named_parameters():
            p.copy_(saved[n])
    return tree


def _assert_close_scaled(got_tree, want_tree, rtol, scale_tol):
    got, want = _leaves(got_tree), _leaves(want_tree)
    assert got.keys() == want.keys()
    for k, w in want.items():
        scale = float(np.abs(w).max()) or 1.0
        np.testing.assert_allclose(got[k], w, rtol=rtol, atol=scale_tol * scale,
                                   err_msg=k)


@pytest.mark.parametrize("momentum", [0.9, 0.5])
def test_batchnorm_matches_flax(momentum):
    x = (np.random.RandomState(0).randn(6, 5, 5, 7) * 2 + 1).astype(np.float32)
    ref = fnn.BatchNorm(use_running_average=False, momentum=momentum,
                        epsilon=1e-5, dtype=jnp.float32)
    rs = np.random.RandomState(1)
    variables = {"params": {"scale": rs.randn(7).astype(np.float32),
                            "bias": rs.randn(7).astype(np.float32)},
                 "batch_stats": {"mean": rs.randn(7).astype(np.float32),
                                 "var": rs.rand(7).astype(np.float32) + 0.5}}
    y_j, mut = ref.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    y_eval_j = fnn.BatchNorm(use_running_average=True, epsilon=1e-5).apply(
        variables, jnp.asarray(x))

    bn = BatchNorm(7, momentum=momentum)
    load_jax_variables(bn, variables)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    bn.eval()
    y_eval = bn(xt).permute(0, 2, 3, 1)
    bn.train()
    y = bn(xt).permute(0, 2, 3, 1)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(y_eval.detach().numpy(), np.asarray(y_eval_j),
                               rtol=1e-5, atol=1e-5)
    stats = export_jax_variables(bn)["batch_stats"]
    for k in ("mean", "var"):
        np.testing.assert_allclose(stats[k], np.asarray(mut["batch_stats"][k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    assert not hasattr(bn, "num_batches_tracked")


@pytest.mark.parametrize("name", NAMES)
def test_resnet_eval_stages_match_jax(name):
    x = np.random.RandomState(2).randn(2, 64, 64, 3).astype(np.float32)
    jm = JAX_BACKBONE.get(name)(num_classes=0, dtype=jnp.float32)
    pm = BACKBONE.get(name)(num_classes=0, dtype=torch.float32)
    variables = _with_stats(port_init(pm, 0), 3)
    out_j = jax.jit(lambda v, xx: jm.apply(v, xx, train=False))(variables, x)

    load_jax_variables(pm, variables)
    pm.eval()
    with torch.no_grad():
        out_t = pm(torch.from_numpy(x))
    assert set(out_t) == set(out_j) == {"stem", "c2", "c3", "c4", "c5", "pool"}
    for key in out_j:
        np.testing.assert_allclose(out_t[key].numpy(), np.asarray(out_j[key]),
                                   rtol=1e-4, atol=1e-5, err_msg=key)
    assert out_t["c5"].shape[-1] == feature_dim(name) == pm.out_channels


@pytest.mark.parametrize("s2d", [False, True], ids=["plain_stem", "s2d_stem"])
def test_stem_space_to_depth_matches_the_port(s2d):
    x = np.random.RandomState(7).randn(2, 32, 32, 3).astype(np.float32)
    jm = JaxBaseline(backbone_name="resnet18", num_classes=3, dtype=jnp.float32,
                     stem_space_to_depth=s2d)
    # the port runs the plain 7x7/2 conv whatever the key says
    pm = MODEL.get("ResNet18")(ConfigNode({"num_classes": 3, "dtype": "float32",
                                           "stem_space_to_depth": s2d}))
    variables = _with_stats(port_init(pm, 8), 9)
    want = jm.apply(variables, x, train=False)["logits"]
    load_jax_variables(pm, variables)
    pm.eval()
    with torch.no_grad():
        got = pm(torch.from_numpy(x))["logits"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("model_name", ["ResNet18", "ResNet34", "ResNet50",
                                        "ResNet101", "ResNet152", "VGG16"])
def test_baseline_registrations_and_bridge_names(model_name):
    """Every Baseline registration has the JAX model's variables tree, names
    and shapes, through the bridge both ways."""
    cfg = {"num_classes": 7}
    jm = JAX_MODEL.get(model_name)(JaxConfigNode(cfg))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, 32, 32, 3)),
                                            train=False))
    pm = MODEL.get(model_name)(ConfigNode(cfg))
    assert pm.backbone.dtype == torch.bfloat16
    exported = export_jax_variables(pm)
    assert set(exported) == set(shapes)
    want = {jax.tree_util.keystr(k): tuple(v.shape)
            for k, v in jax.tree_util.tree_leaves_with_path(shapes)}
    got = {k: tuple(v.shape) for k, v in _leaves(exported).items()}
    assert got == want
    # and back: the exported tree fills every parameter and buffer
    load_jax_variables(pm, exported)


def test_bridge_round_trip_with_batch_stats():
    jm = JaxBaseline(backbone_name="resnet18", num_classes=3, dtype=jnp.float32)
    variables = _with_stats(  # the JAX init, compiled
        jax.jit(jm.init)(jax.random.PRNGKey(10), jnp.zeros((1, 32, 32, 3))), 11)
    pm = BaselineClassifier("resnet18", 3, dtype=torch.float32)
    load_jax_variables(pm, variables)
    back = export_jax_variables(pm)
    assert set(back) == {"params", "batch_stats"}
    want = _leaves({k: variables[k] for k in ("params", "batch_stats")})
    got = _leaves(back)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    names = {n for n, _ in pm.named_parameters()}
    assert {"backbone.conv1.weight", "backbone.bn1.weight",
            "backbone.layer1_0.conv1.weight", "backbone.layer2_0.downsample_conv.weight",
            "backbone.layer2_0.downsample_bn.bias", "fc.weight"} <= names
    assert "backbone.bn1.running_var" in dict(pm.named_buffers())
    # a copy, not a view: a later update leaves the export alone
    with torch.no_grad():
        pm.backbone.bn1.running_mean.add_(1.0)
    np.testing.assert_array_equal(back["batch_stats"]["backbone"]["bn1"]["mean"],
                                  want["['batch_stats']['backbone']['bn1']['mean']"])
    # a missing buffer raises, as a missing parameter does
    partial = {"params": variables["params"]}
    with pytest.raises(KeyError, match="running_mean"):
        load_jax_variables(pm, partial)


def test_bridge_keeps_vgg_names():
    """The convN -> features.N rewrite applies inside the VGG trunk only."""
    from hawkeye_tpu_torch.models.methods.bcnn import BCNN

    pm = BCNN(num_classes=3, backbone_name="vgg11", dtype=torch.float32)
    params = export_jax_variables(pm)["params"]
    assert set(export_jax_variables(pm)) == {"params"}
    assert sorted(params["backbone"]) == ["conv0", "conv11", "conv13", "conv16",
                                          "conv18", "conv3", "conv6", "conv8"]
    assert params["backbone"]["conv0"]["kernel"].shape == (3, 3, 3, 64)
    rn = export_jax_variables(BaselineClassifier("resnet18", 3))["params"]
    assert "conv1" in rn["backbone"] and "features" not in str(list(rn["backbone"]))
