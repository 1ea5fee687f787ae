"""The port's VGG with BatchNorm, its classifier and the torchvision VGG
converter against the JAX package's, on the CPU.

* ``vgg11_bn`` at 32x32, batch 4, in float64 on both sides, BatchNorm
  scales, biases and running statistics at random: in train mode the stage
  dict, every parameter's gradient and the updated running statistics, in
  eval mode the stage dict, each within 1e-10 of the tensor's largest
  value (the pool kernels' plain versions run on the BN path, which defers
  each pool's ReLU into them).
* The classifier (``num_classes > 0``) on a small BN trunk (8 and 16
  channels) whose last map is 7x7 or 14x14 (the equal-window average pool):
  its input, the map flattened in NHWC order and rounded to float32 on both
  sides, within 1e-7; the JAX classifier computes in float32 whatever its
  input's dtype
  (``nn.Dense(dtype=jnp.float32)``), so its logits and ``fc0``'s gradient
  are held at float32's 1e-5 of their largest value, the port's head in
  float32 too. Dropout at rate 0 for the train-mode comparison; at 0.5 the
  port draws its masks from the caller's generator.
* ``convert_torchvision_vgg`` on a seeded torchvision-layout ``vgg_bn`` state
  dict with a classifier, written to ``tmp_path`` and read through
  ``load_pretrained_backbone``: every converted tensor equal to the JAX
  converter's, ``classifier.0``'s NCHW-to-NHWC permutation included.
* BCNN and CBCNN build on ``vgg16_bn`` from their recipes; BCNN's eval
  logits at 32x32 within 1e-5 of the JAX model's (a float32 head).
"""

import torch_threads  # noqa: F401  (PyTorch's thread count: see the module)
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hawkeye_tpu.models  # noqa: F401
import hawkeye_tpu_torch.models  # noqa: F401
from hawkeye_tpu.models.backbones.vgg import VGG as JaxVGG
from hawkeye_tpu.models.backbones.vgg import _VGG_CFGS
from hawkeye_tpu.models.methods.bcnn import BCNN as JaxBCNN
from hawkeye_tpu.models.weights import convert_torchvision_vgg as jax_convert_vgg
from hawkeye_tpu_torch.config import ConfigNode, load_yaml_config
from hawkeye_tpu_torch.models import bridge, build_model, export_jax_variables
from hawkeye_tpu_torch.models import load_jax_variables
from hawkeye_tpu_torch.models.backbones.norm import BatchNorm
from hawkeye_tpu_torch.models.backbones.vgg import VGG
from hawkeye_tpu_torch.models.methods.bcnn import BCNN
from hawkeye_tpu_torch.models.weights import load_pretrained_backbone
from test_torch_osme import perturbed
from test_torch_resnet import init_in_float32

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-10
SMALL = [8, "M", 16, "M"]  # a BN trunk small enough for the 4096-wide head


def _close(got, want, tol=TOL):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=0,
                               atol=tol * (np.abs(want).max() or 1.0))


def _tree64(module, collection, grads=False):
    """The module's parameters' gradients (``grads``) or a collection, in
    the flax layout, in float64 (the bridge exports float32)."""
    tree = {}
    params = dict(module.named_parameters())
    for (col, path), (name, t) in bridge._name_map(module).items():
        if col != collection:
            continue
        t = params[name].grad if grads else t
        node = tree
        for seg in path[:-1]:
            node = node.setdefault(seg, {})
        node[path[-1]] = bridge._to_jax_layout(t.detach().double().numpy(), path[-1])
    return tree


def _assert_trees(got, want, tol=TOL):
    """Leaf by leaf within ``tol`` of the leaf's largest value; a conv's
    bias under BatchNorm has a gradient of 0 in exact arithmetic (the norm
    takes the mean out), so it is held to ``tol`` of its kernel's largest
    gradient."""
    flat_g = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(got)}
    flat_w = {jax.tree_util.keystr(k): v for k, v in jax.tree_util.tree_leaves_with_path(want)}
    assert flat_g.keys() == flat_w.keys()
    for k, w in flat_w.items():
        scale = np.abs(np.asarray(w)).max()
        kernel = k.replace("['bias']", "['kernel']")
        if k.endswith("['bias']") and kernel in flat_w:
            scale = max(scale, np.abs(np.asarray(flat_w[kernel])).max())
        np.testing.assert_allclose(np.asarray(flat_g[k], np.float64), w, rtol=0,
                                   atol=tol * (scale or 1.0), err_msg=k)


def _pair(cfg, num_classes=0, size=32, seed=0, dropout_rate=0.0, f64_head=True):
    """The port's VGG with BN (float64 trunk; the head float32 unless
    ``f64_head``) and the JAX one, on the port's init with BatchNorm at
    random, and the variables in float64."""
    pm = VGG(cfg, batch_norm=True, num_classes=num_classes, dtype=torch.float64,
             dropout_rate=dropout_rate)
    init_in_float32(pm, seed)
    variables = perturbed(export_jax_variables(pm), seed)
    load_jax_variables(pm, variables)
    pm.features.double()
    if f64_head and num_classes:
        pm.double()
    jm = JaxVGG(cfg=cfg, batch_norm=True, num_classes=num_classes,
                dropout_rate=dropout_rate, dtype=jnp.float64, param_dtype=jnp.float64)
    variables = jax.tree.map(lambda a: np.asarray(a, np.float64), variables)
    return pm, jm, variables


def _jax_train(jm, variables, x, r):
    """JAX train-mode stages, gradients of ``sum(r * pooled_features)`` plus
    the logits' sum where there are logits, and the updated statistics."""
    def loss(params):
        out, mut = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                            x, train=True, mutable=["batch_stats"])
        val = (out["pooled_features"] * r).sum()
        if "logits" in out:
            val = val + (out["logits"].astype(jnp.float64) ** 2).sum()
        return val, (out, mut["batch_stats"])

    with jax.enable_x64(True):
        (_, (out, stats)), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            jax.tree.map(jnp.asarray, variables["params"]))
        return jax.device_get((out, stats, grads))


def _port_train(pm, x, r, generator=None):
    pm.train()
    for p in pm.parameters():
        p.grad = None
    out = pm(torch.from_numpy(x), generator=generator)
    val = (out["pooled_features"] * torch.from_numpy(r)).sum()
    if "logits" in out:
        val = val + (out["logits"].double() ** 2).sum()
    val.backward()
    return {k: v.detach() for k, v in out.items()}


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_vgg11_bn_matches_jax_in_float64(mode):
    rs = np.random.RandomState(1)
    x = rs.randn(4, 32, 32, 3)
    r = rs.randn(4, 1, 1, 512)
    pm, jm, variables = _pair(_VGG_CFGS["A"])
    assert sum(isinstance(m, BatchNorm) for m in pm.modules()) == 8
    assert not pm.remat_first and "features.1.running_var" in pm.state_dict()
    if mode == "eval":
        with jax.enable_x64(True):
            want = jax.device_get(jax.jit(lambda v, xx: jm.apply(v, xx, train=False))(
                variables, x))
        with torch.no_grad():
            got = pm.eval()(torch.from_numpy(x))
    else:
        want, stats, grads = _jax_train(jm, variables, x, r)
        got = _port_train(pm, x, r)
        _assert_trees(_tree64(pm, "params", grads=True), grads)
        _assert_trees(_tree64(pm, "batch_stats"), stats)
    assert got.keys() == want.keys()
    for k in want:
        _close(got[k].numpy(), want[k])


@pytest.mark.parametrize("size", [28, 56], ids=["7x7", "14x14"])
def test_vgg_classifier_matches_jax(size):
    rs = np.random.RandomState(size)
    x = rs.randn(2, size, size, 3)
    r = rs.randn(2, 1, 1, 16)
    pm, jm, variables = _pair(SMALL, num_classes=5, size=size, seed=2, f64_head=False)
    assert pm.fc0.weight.shape == (4096, 49 * 16) and pm.fc0.weight.dtype == torch.float32
    want, stats, grads = _jax_train(jm, variables, x, r)
    got = _port_train(pm, x, r)
    _close(got["pool"].numpy(), want["pool"], 1e-7)  # float32 on both sides
    _close(got["logits"].numpy(), want["logits"], 1e-5)
    _close(pm.fc0.weight.grad.T.numpy(), grads["fc0"]["kernel"], 1e-5)
    _assert_trees(_tree64(pm, "batch_stats"), stats)
    with jax.enable_x64(True):  # on the statistics the train step left
        want = jax.device_get(jm.apply({**variables, "batch_stats": stats}, x,
                                       train=False))
    with torch.no_grad():
        got = pm.eval()(torch.from_numpy(x))
    _close(got["logits"].numpy(), want["logits"], 1e-5)
    # dropout at 0.5: the masks come from the caller's generator
    pm.dropout_rate = 0.5
    with pytest.raises(ValueError, match="generator"):
        pm.train()(torch.from_numpy(x))
    a, b = (pm(torch.from_numpy(x), generator=torch.Generator().manual_seed(3))["logits"]
            for _ in range(2))
    assert torch.equal(a, b)


def test_torchvision_vgg_bn_converter_matches_jax(tmp_path):
    gen = torch.Generator().manual_seed(4)
    ref = VGG(SMALL, batch_norm=True, num_classes=5, dtype=torch.float32)
    sd = {}
    for name, t in ref.state_dict().items():  # torchvision's names and layouts
        if name.startswith("fc"):
            name = f"classifier.{name[2:]}"
            if name == "classifier.0.weight":  # torchvision flattens NCHW
                t = torch.empty(4096, 16 * 49)
        sd[name] = torch.randn(t.shape, generator=gen) * 0.1
        if name.endswith("running_var"):
            sd[name] = sd[name].abs() + 0.5
    sd["features.1.num_batches_tracked"] = torch.tensor(3)
    path = tmp_path / "vgg_bn.pth"
    torch.save(sd, path)

    class Holder(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.backbone = VGG(SMALL, batch_norm=True, num_classes=5,
                                dtype=torch.float32)

    held = Holder()
    report = load_pretrained_backbone(held, str(path), "vgg")
    assert report is not None
    got = export_jax_variables(held.backbone)
    params, stats = jax_convert_vgg({k: v.numpy() for k, v in sd.items()})
    flat = {"/".join(k): v for k, v in jax.tree_util.tree_flatten_with_path(got)[0]
            for k in [tuple(str(p.key) for p in k)]}
    want = {f"params/{k}": v for k, v in params.items()}
    want.update({f"batch_stats/{k}": v for k, v in stats.items()})
    assert flat.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(flat[k], v, err_msg=k)
    # the permuted fc0 reads the NHWC flatten: the same logits as torchvision's
    # NCHW flatten through the original weight
    m = held.backbone.eval()
    x = torch.randn(2, 28, 28, 3, generator=gen)
    with torch.no_grad():
        out = m(x)
        nchw = out["pooled_features"].permute(0, 3, 1, 2).reshape(2, -1)
        y0 = torch.relu(nchw @ sd["classifier.0.weight"].T + sd["classifier.0.bias"])
    torch.testing.assert_close(torch.relu(m.fc0(out["pool"])), y0, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("recipe", ["BCNN_S2.yaml", "CBCNN_S2.yaml"])
def test_bcnn_and_cbcnn_build_on_vgg16_bn(recipe):
    cfg = load_yaml_config(os.path.join(ROOT, "configs", recipe)).to_dict()
    cfg["model"]["backbone"] = "vgg16_bn"
    model = build_model(ConfigNode(cfg["model"]).freeze(), 32)
    assert sum(isinstance(m, BatchNorm) for m in model.backbone.modules()) == 13
    assert model.backbone.batch_norm and model.backbone.efficient_pool
    if recipe.startswith("BCNN"):
        pm = BCNN(num_classes=7, backbone_name="vgg16_bn", dtype=torch.float32)
        init_in_float32(pm, 5)
        variables = perturbed(export_jax_variables(pm), 5)
        load_jax_variables(pm, variables)
        x = np.random.RandomState(6).randn(2, 32, 32, 3).astype(np.float32)
        jm = JaxBCNN(num_classes=7, backbone_name="vgg16_bn", dtype=jnp.float32)
        want = jax.jit(lambda v, xx: jm.apply(v, xx, train=False))(variables, x)
        with torch.no_grad():
            got = pm.eval()(torch.from_numpy(x))
        _close(got["logits"].numpy(), np.asarray(want["logits"]), 1e-5)
