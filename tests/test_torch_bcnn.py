"""The port's VGG and BCNN (hawkeye_tpu_torch/models) against the JAX
package at small size, float32 on both sides, with the weights carried
across by the bridge: the port's init (``port_init``, so that no JAX init
runs), and the JAX init for the bridge's round trip. Forward rtol 1e-4 / atol 1e-5; parameter gradients
rtol 1e-3, with an atol of 1e-3 of each tensor's largest gradient for the
entries near zero (conv summation order differs between XLA and PyTorch on
the CPU)."""

import torch_threads  # noqa: F401  (PyTorch's thread count: see the module)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hawkeye_tpu.models  # noqa: F401
import hawkeye_tpu_torch.models  # noqa: F401
from hawkeye_tpu.models.backbones import vgg as jax_vgg
from hawkeye_tpu.models.methods.bcnn import BCNN as JaxBCNN
from hawkeye_tpu_torch.models import export_jax_variables, load_jax_variables
from hawkeye_tpu_torch.models.backbones import vgg as port_vgg
from hawkeye_tpu_torch.models.methods.bcnn import BCNN as PortBCNN
from test_torch_resnet import port_init


def _assert_grads_close(got_tree, want_tree):
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want_tree))
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got_tree))
    assert set(map(str, flat_got)) == set(map(str, flat_want))
    for k, want in flat_want.items():
        want = np.asarray(want)
        scale = float(np.abs(want).max()) or 1.0
        np.testing.assert_allclose(np.asarray(flat_got[k]), want, rtol=1e-3,
                                   atol=1e-3 * scale, err_msg=str(k))


def _port_grads(module):
    """Parameter gradients in the flax layout (zeros where none flowed)."""
    for p in module.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    saved = {n: p.detach().clone() for n, p in module.named_parameters()}
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(p.grad)
    tree = export_jax_variables(module)["params"]
    with torch.no_grad():
        for n, p in module.named_parameters():
            p.copy_(saved[n])
    return tree


@pytest.mark.parametrize("name,cfg", [("vgg11", "A"), ("vgg16", "D")])
def test_vgg_stages_and_grads_match_jax(name, cfg):
    x = np.random.RandomState(0).randn(2, 32, 32, 3).astype(np.float32)
    jm = jax_vgg.VGG(cfg=jax_vgg._VGG_CFGS[cfg], num_classes=0,
                     dtype=jnp.float32)
    pm = port_vgg.VGG(port_vgg._VGG_CFGS[cfg], dtype=torch.float32)
    variables = port_init(pm, 0)

    def loss_fn(params):
        out = jm.apply({"params": params}, jnp.asarray(x))
        return (out["pooled_features"] ** 2).sum() + out["features"].sum(), out

    (_, out_j), g_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])

    out_t = pm(torch.from_numpy(x))
    ((out_t["pooled_features"] ** 2).sum() + out_t["features"].sum()).backward()

    for key in ("features", "pooled_features", "pool"):
        np.testing.assert_allclose(out_t[key].detach().numpy(),
                                   np.asarray(out_j[key]), rtol=1e-4, atol=1e-5,
                                   err_msg=key)
    _assert_grads_close(_port_grads(pm), g_j)


@pytest.mark.parametrize("fused", [False, True], ids=["plain_head", "fused_head"])
def test_bcnn_logits_and_grads_match_jax(fused):
    x = np.random.RandomState(1).randn(2, 64, 64, 3).astype(np.float32)
    y = np.array([1, 3])
    jm = JaxBCNN(num_classes=4, stage=2, backbone_name="vgg11",
                 fused_pooling=fused, dtype=jnp.float32)
    pm = PortBCNN(num_classes=4, stage=2, backbone_name="vgg11",
                  fused_pooling=fused, dtype=torch.float32)
    variables = port_init(pm, 2)

    def loss_fn(params):
        logits = jm.apply({"params": params}, jnp.asarray(x))["logits"]
        return -jax.nn.log_softmax(logits)[jnp.arange(2), y].sum(), logits

    (_, logits_j), g_j = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])

    logits_t = pm(torch.from_numpy(x))["logits"]
    (-torch.log_softmax(logits_t, -1)[torch.arange(2), torch.from_numpy(y)]
     .sum()).backward()

    np.testing.assert_allclose(logits_t.detach().numpy(), np.asarray(logits_j),
                               rtol=1e-4, atol=1e-5)
    _assert_grads_close(_port_grads(pm), g_j)


def test_stage1_backbone_gets_no_gradient():
    x = np.random.RandomState(3).randn(2, 64, 64, 3).astype(np.float32)
    jm = JaxBCNN(num_classes=4, stage=1, backbone_name="vgg11",
                 dtype=jnp.float32)
    pm = PortBCNN(num_classes=4, stage=1, backbone_name="vgg11",
                  dtype=torch.float32)
    variables = port_init(pm, 3)
    g_j = jax.jit(jax.grad(lambda p: jm.apply({"params": p}, jnp.asarray(x))[
        "logits"].sum()))(variables["params"])
    assert all(float(jnp.abs(v).max()) == 0.0
               for v in jax.tree_util.tree_leaves(g_j["backbone"]))

    pm(torch.from_numpy(x))["logits"].sum().backward()
    assert all(p.grad is None for p in pm.backbone.parameters())
    assert float(pm.fc.weight.grad.abs().max()) > 0.0
    _assert_grads_close(_port_grads(pm), g_j)


def test_bridge_round_trip_and_names():
    jm = JaxBCNN(num_classes=3, backbone_name="vgg11", dtype=jnp.float32)
    variables = jax.device_get(  # compiled as one program: the same values
        jax.jit(jm.init)(jax.random.PRNGKey(4), jnp.zeros((1, 32, 32, 3))))
    pm = PortBCNN(num_classes=3, backbone_name="vgg11", dtype=torch.float32)
    load_jax_variables(pm, variables)
    back = export_jax_variables(pm)
    for (ka, a), (kb, b) in zip(
            sorted(jax.tree_util.tree_leaves_with_path(variables["params"]),
                   key=lambda kv: str(kv[0])),
            sorted(jax.tree_util.tree_leaves_with_path(back["params"]),
                   key=lambda kv: str(kv[0]))):
        assert str(ka) == str(kb)
        np.testing.assert_array_equal(np.asarray(a), b)
    names = {n for n, _ in pm.named_parameters()}
    assert "backbone.features.0.weight" in names  # conv0 (_Conv3x3Params)
    assert "backbone.features.18.weight" in names  # torchvision index
    with pytest.raises(KeyError):
        load_jax_variables(pm, {"params": {"fc": variables["params"]["fc"]}})
