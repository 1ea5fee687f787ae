"""The port's CBCNN and MPN (hawkeye_tpu_torch/models/methods) against the
JAX package's on the CPU, from the same weights carried by the bridge.

CBCNN (vgg11 trunk, 32x32, d = 64), float32: logits rtol 1e-4 / atol 1e-5;
parameter gradients rtol 1e-3 with an atol of 1e-3 of each tensor's largest
gradient; in stage 1 the trunk gets no gradient and ``fc`` the JAX one.
Its sketches, spectra and irDFT matrices are in no state dict. MPN's
variables tree without the reduction; its train step is in
test_torch_mpn.py and test_torch_mpn_resnet50.py."""

import torch_threads  # noqa: F401  (PyTorch's thread count: see the module)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hawkeye_tpu.models  # noqa: F401
import hawkeye_tpu_torch.models  # noqa: F401
from hawkeye_tpu.models.methods.cbcnn import CBCNN as JaxCBCNN
from hawkeye_tpu.models.methods.mpn import MPN as JaxMPN
from hawkeye_tpu_torch import MODEL
from hawkeye_tpu_torch.config import ConfigNode
from hawkeye_tpu_torch.models import export_jax_variables, load_jax_variables
from hawkeye_tpu_torch.models.methods.cbcnn import CBCNN
from test_torch_resnet import _assert_close_scaled, _port_grads


def ce(logits, y):
    return -jax.nn.log_softmax(logits)[jnp.arange(len(y)), y].mean()


def _cbcnn_pair(stage):
    x = np.random.RandomState(0).randn(2, 32, 32, 3).astype(np.float32)
    jm = JaxCBCNN(num_classes=5, stage=stage, output_channel=64,
                  backbone_name="vgg11", dtype=jnp.float32)
    # compiled as one program: the values of the op-by-op init
    variables = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x)))
    pm = CBCNN(num_classes=5, stage=stage, output_channel=64,
               backbone_name="vgg11", dtype=torch.float32)
    load_jax_variables(pm, variables)
    return x, jm, variables, pm


@pytest.mark.parametrize("stage", [2, 1])
def test_cbcnn_logits_and_gradients_match_jax(stage):
    x, jm, variables, pm = _cbcnn_pair(stage)
    y = np.array([1, 3])

    def loss_fn(params):
        out = jm.apply({**variables, "params": params}, jnp.asarray(x), train=True)
        return ce(out["logits"], y), out["logits"]

    (_, logits_j), g_j = jax.device_get(jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"]))
    pm.train()
    out = pm(torch.from_numpy(x))
    assert out["features"].shape == (2, 64)
    torch.nn.functional.cross_entropy(out["logits"], torch.from_numpy(y)).backward()
    np.testing.assert_allclose(out["logits"].detach().numpy(), logits_j,
                               rtol=1e-4, atol=1e-5)
    if stage == 1:
        assert all(p.grad is None for p in pm.backbone.parameters())
        assert all(float(np.abs(v).max()) == 0.0
                   for v in jax.tree_util.tree_leaves(g_j["backbone"]))
        g_j = {"fc": g_j["fc"]}
        got = {"fc": {"kernel": pm.fc.weight.grad.numpy().T,
                      "bias": pm.fc.bias.grad.numpy()}}
    else:
        got = _port_grads(pm)
    _assert_close_scaled(got, g_j, rtol=1e-3, scale_tol=1e-3)


def test_cbcnn_constants_stay_out_of_state_dict_and_bridge():
    x, jm, variables, pm = _cbcnn_pair(2)
    assert "fourier_cache" in variables
    state = pm.state_dict()
    assert not [k for k in state if k.startswith(("sketch", "spectrum", "irdft"))]
    assert {n for n, _ in pm.named_buffers()} >= {"sketch1", "sketch2",
                                                  "irdft_cos", "irdft_sin"}
    exported = export_jax_variables(pm)
    assert set(exported) == {"params"}
    want = {jax.tree_util.keystr(k): v.shape for k, v in
            jax.tree_util.tree_leaves_with_path(variables["params"])}
    got = {jax.tree_util.keystr(k): v.shape for k, v in
           jax.tree_util.tree_leaves_with_path(exported["params"])}
    assert got == want
    # the sketches are the JAX model's, and the irDFT matrices its cache
    np.testing.assert_array_equal(pm.sketch1.numpy(), jm.bind(variables).sketch1)
    np.testing.assert_array_equal(pm.irdft_cos.numpy(),
                                  variables["fourier_cache"]["irdft"][0])


def test_mpn_without_reduction_and_config_keys():
    cfg = ConfigNode({"name": "MPN", "num_classes": 4, "backbone": "resnet18",
                      "dimension_reduction": None, "iter_num": 2,
                      "input_dim": 2048, "coupled_newton_schulz": False})
    pm = MODEL.get("MPN")(cfg)
    assert not hasattr(pm, "dr_conv") and pm.fc.in_features == 512 * 513 // 2
    assert pm.iter_num == 2 and not pm.coupled_newton_schulz
    jm = JaxMPN(num_classes=4, backbone_name="resnet18", dimension_reduction=None)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.zeros((1, 32, 32, 3))))
    got = {jax.tree_util.keystr(k): tuple(v.shape) for k, v in
           jax.tree_util.tree_leaves_with_path(export_jax_variables(pm))}
    want = {jax.tree_util.keystr(k): tuple(v.shape) for k, v in
            jax.tree_util.tree_leaves_with_path(shapes)}
    assert got == want
