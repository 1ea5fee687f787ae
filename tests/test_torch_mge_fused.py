"""MGE-CNN's ``fused_experts`` in the port (models/methods/mge.py,
``backbones/resnet.stacked_forward``) against its sequential path and the
JAX package's fused path, on ``TINY`` trunks (one BasicBlock per stage) at
64x64, 5 classes, batch 3, BatchNorm scales, biases and statistics at
random.

* Against the port's sequential path, the whole model in float64: a
  train-mode forward with the labels (the CAMs' classes) and its backward
  give ``logits``, ``all_logits``, ``pr_gate``, every parameter's gradient
  and every running statistic within 1e-10 of the tensor's largest value
  (phase A folds no statistics; phase B folds each backbone's own); the
  eval forward, whose CAMs follow each expert's argmax, the same. Both
  paths have one parameter tree, so one state dict serves both.
* Against the JAX package's fused path (``stack_expert_variables`` of the
  same variables), trunks in float64 and heads in float32 on both sides as
  the JAX heads are: a train-mode forward with the labels and an eval
  forward, ``logits``, ``all_logits`` and ``pr_gate`` within 1e-6 of their
  largest value, the crop boxes identical, and the running statistics of
  expert 0 and the gate backbone (which see the image) within 1e-10, those
  of experts 1 and 2 (which see the crops) within 1e-6 (``CROP_TOL``).
"""

import torch_threads  # noqa: F401  (PyTorch's thread count: see the module)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hawkeye_tpu.models  # noqa: F401
from hawkeye_tpu.models.methods import mge as jax_mge
from hawkeye_tpu_torch.models import load_jax_variables
from hawkeye_tpu_torch.models.methods import mge
from test_torch_ntsnet import port_variables
from test_torch_resnet import TINY
from test_torch_resnet import tiny_trunk  # noqa: F401  (a fixture: pytestmark)
from test_torch_s3n_mge import MGE_KEYS, _recording_cam_bbox, _recording_crop
from test_torch_vgg_bn import _assert_trees, _tree64

pytestmark = pytest.mark.usefixtures("tiny_trunk")

KW = dict(num_classes=5, image_size=64, backbone_name=TINY)
TOL = 1e-10
# experts 1 and 2 see crops, whose resample coordinates the JAX package
# rounds one way under jit and another op by op (its own two runs' crop
# statistics differ by ~1e-8 in float64 mode; the port's are 5e-11 from the
# jitted run's)
CROP_TOL = 1e-6


def _close(got, want, tol):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=tol * np.abs(want).max())


def _inputs():
    rs = np.random.RandomState(10)
    return rs.rand(3, 64, 64, 3) * 2 - 1, np.array([0, 3, 4])


def _pair(f64_heads):
    """The port's sequential and fused models on one state dict."""
    models = []
    for fused in (False, True):
        pm = mge.MGECNN(dtype=torch.float64, fused_experts=fused, **KW)
        if f64_heads:
            pm.double()
        else:
            for trunk in (*(getattr(pm, f"expert_{i}").backbone for i in range(3)),
                          pm.gate_backbone):
                trunk.double()
        models.append(pm)
    variables = port_variables(models[0], 9)
    for pm in models:
        load_jax_variables(pm, variables)
    return models, variables


def test_fused_matches_sequential_in_float64():
    (seq, fused), _ = _pair(f64_heads=True)
    x, y = (torch.from_numpy(a) for a in _inputs())
    outs = []
    for pm in (seq, fused):
        out = pm.train()(x, labels=y)
        (out["all_logits"] ** 2).sum().backward()
        outs.append(out)
    for k in MGE_KEYS:
        _close(outs[1][k].detach(), outs[0][k].detach(), TOL)
    _assert_trees(_tree64(fused, "params", grads=True), _tree64(seq, "params", grads=True))
    _assert_trees(_tree64(fused, "batch_stats"), _tree64(seq, "batch_stats"))
    with torch.no_grad():
        want, got = seq.eval()(x), fused.eval()(x)
    for k in MGE_KEYS:
        _close(got[k], want[k], TOL)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_fused_matches_jax_fused(monkeypatch, train):
    (_, pm), variables = _pair(f64_heads=False)
    jm = jax_mge.MGECNN(dtype=jnp.float64, fused_experts=True, **KW)
    seen_jax, seen = [], []
    monkeypatch.setattr(jax_mge, "crop_resize_bilinear", _recording_crop(seen_jax))
    monkeypatch.setattr(mge, "cam_bbox", _recording_cam_bbox(seen))
    x, y = _inputs()
    with jax.enable_x64(True):
        # float64 statistics, as the port's trunks hold them (float32 ones
        # would fold 0.9 * s in float32); float32 parameters: the heads' dtype
        fused_vars = jax_mge.stack_expert_variables({
            "params": variables["params"],
            "batch_stats": jax.tree.map(lambda a: np.asarray(a, np.float64),
                                        variables["batch_stats"])})
        if train:
            want, mut = jax.device_get(jax.jit(lambda v, xx, yy: jm.apply(
                v, xx, train=True, labels=yy, mutable=["batch_stats"]))(
                    fused_vars, jnp.asarray(x), jnp.asarray(y)))
        else:
            want = jax.device_get(jax.jit(lambda v, xx: jm.apply(v, xx, train=False))(
                fused_vars, jnp.asarray(x)))
    with torch.no_grad():
        got = (pm.train()(torch.from_numpy(x), labels=torch.from_numpy(y)) if train
               else pm.eval()(torch.from_numpy(x)))
    for k in MGE_KEYS:
        _close(got[k], want[k], 1e-6)
    np.testing.assert_array_equal(np.stack(seen), np.stack(seen_jax))
    assert len(seen) == 2
    if train:
        with jax.enable_x64(True):  # stacked in float64
            stats = jax.device_get(jax_mge.stack_expert_variables(
                {"batch_stats": _tree64(pm, "batch_stats")}))
        got = jax.tree_util.tree_leaves_with_path(stats["batch_stats"])
        want = dict(jax.tree_util.tree_leaves_with_path(mut["batch_stats"]))
        assert len(got) == len(want)
        for path, g in got:  # [4, C]: experts 0-2, then the gate backbone
            w = np.asarray(want[path])
            for e, tol in enumerate((TOL, CROP_TOL, CROP_TOL, TOL)):
                _close(g[e], w[e], tol)
