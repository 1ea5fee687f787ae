"""The port's OSME model and MAMC loss (hawkeye_tpu_torch/models/methods/
osme.py, losses/mamc.py) against the JAX package's on the CPU.

The model: a one-block-per-stage trunk (``TINY``; the test's name is from
its resnet18 days),
at 64x64 (a 2x2 ``c5`` map, so the NHWC flatten
order that feeds ``part_fc_{p}`` shows), batch 4 as two classes x two
samples, an eval forward on the bridged running statistics, then one
train-mode step (batch statistics folded into the running ones) through
the MAMC loss. Both models take the same weights: the port's init with
every BatchNorm scale and every bias drawn at random, whose tree and
shapes must be flax's. The trunks and the OSME blocks run in float64
on both sides (``part_fc`` and ``fc`` are float32 in both packages): in
float32 a train-mode ResNet step moves a gradient by ~1e-2 between two
right implementations (``tests/test_torch_resnet_train.py``). Outputs rtol
1e-4 with an atol of 1e-5 of their largest value; the loss rtol 1e-6;
gradients rtol 1e-3 with an atol of 1e-3 of each tensor's largest; running
statistics rtol 1e-5 / atol 1e-5 of the largest.

The loss alone: float32 parts at random, with and without a per-sample
weight of 0 (a padded row out as anchor, positive and negative), values
rtol 1e-5 and gradients rtol 1e-4 / atol 1e-6.

``perturbed``, ``assert_roundtrip`` and ``compare_train_step`` serve the
other method tests of this slice."""

import torch_threads  # noqa: F401  (PyTorch's thread count: see the module)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hawkeye_tpu.models  # noqa: F401
import hawkeye_tpu_torch.models  # noqa: F401
from hawkeye_tpu.losses.mamc import MAMCLoss as JaxMAMCLoss
from hawkeye_tpu.models.methods.osme import OSMENet as JaxOSMENet
from hawkeye_tpu_torch.losses.mamc import MAMCLoss, npairs_mamc
from hawkeye_tpu_torch.models import (
    export_jax_variables,
    init_parameters,
    load_jax_variables,
)
from hawkeye_tpu_torch.models.methods.osme import OSMENet
from test_torch_resnet import TINY, _assert_close_scaled, _leaves, _port_grads, _with_stats
from test_torch_resnet import tiny_trunk  # noqa: F401  (a fixture: pytestmark)

pytestmark = pytest.mark.usefixtures("tiny_trunk")


def perturbed(variables, seed):
    """The variables with mild random running statistics, every BatchNorm
    scale at 1 + 0.3 N(0, 1) and every bias at 0.1 N(0, 1)."""
    rs = np.random.RandomState(seed)
    variables = (_with_stats(variables, seed) if "batch_stats" in variables
                 else jax.device_get(variables))

    def draw(path, a):
        key = jax.tree_util.keystr(path)
        if key.endswith("['scale']"):
            return (1.0 + 0.3 * rs.randn(*a.shape)).astype(np.float32)
        if key.endswith("['bias']"):
            return (0.1 * rs.randn(*a.shape)).astype(np.float32)
        return np.asarray(a)

    return {**variables, "params": jax.tree_util.tree_map_with_path(
        draw, variables["params"])}


def shared_variables(jm, pm, x_shape, seed, **init_kw):
    """Variables for both models: the port's init, perturbed, in the flax
    layout; their tree and shapes must be those of ``jm.init`` (traced by
    ``jax.eval_shape``, which compiles nothing)."""
    init_parameters(pm, torch.Generator().manual_seed(seed))
    variables = perturbed(export_jax_variables(pm), seed)
    with jax.enable_x64(True):
        want = jax.eval_shape(lambda: jm.init(
            {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
            jnp.zeros(x_shape), train=True, **init_kw))
    got = {k: v.shape for k, v in _leaves(variables).items()}
    assert got == {jax.tree_util.keystr(k): v.shape
                   for k, v in jax.tree_util.tree_leaves_with_path(want)}
    return variables


def assert_roundtrip(module, variables):
    """The bridge filled every parameter and buffer once (load raises
    otherwise) and gives back exactly what it took."""
    got, want = _leaves(export_jax_variables(module)), _leaves(variables)
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v.astype(np.float32), err_msg=k)


def jax_train_step(jm, variables, x, criterion, batch, f64=True, **kw):
    """One train-mode forward and backward of ``jm`` through ``criterion``:
    (loss, outputs, gradients, new batch statistics) as numpy."""
    with jax.enable_x64(f64):
        dtype = jnp.float64 if f64 else jnp.float32
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

        def loss_fn(p):
            out, mut = jm.apply({"params": p, "batch_stats": variables["batch_stats"]},
                                jnp.asarray(x, dtype), train=True,
                                mutable=["batch_stats"], **kw)
            return criterion(out, jbatch), (out, mut["batch_stats"])

        (loss, (out, stats)), grads = jax.device_get(jax.jit(
            jax.value_and_grad(loss_fn, has_aux=True))(variables["params"]))
    return loss, out, grads, stats


def compare_train_step(jm, pm, variables, x, jax_crit, port_crit, batch,
                       keys=("logits",), jax_kw=None, port_kw=None, f64=True,
                       zero_grads=(), loss_rtol=1e-6, out_atol=1e-5):
    """``jm`` and the port's ``pm`` (its trunk already in float64 where
    ``f64``), one train-mode step each from ``variables``; returns the
    port's outputs. ``zero_grads`` names gradients that are 0 in exact
    arithmetic (a bias right before a BatchNorm): both must be below 1e-6
    of the model's largest gradient, and they are not compared."""
    loss_j, out_j, g_j, stats_j = jax_train_step(jm, variables, x, jax_crit, batch,
                                                 f64, **(jax_kw or {}))
    load_jax_variables(pm, variables)
    assert_roundtrip(pm, variables)
    pm.train()
    out = pm(torch.from_numpy(x).to(torch.float64 if f64 else torch.float32),
             **(port_kw or {}))
    loss = port_crit(out, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=loss_rtol)
    for k in keys:
        want = np.asarray(out_j[k])
        np.testing.assert_allclose(out[k].detach().numpy(), want, rtol=1e-4,
                                   atol=out_atol * np.abs(want).max(), err_msg=k)
    got = _port_grads(pm)
    if zero_grads:
        g_j = jax.tree_util.tree_map(np.array, g_j)  # writable copies
        top = max(np.abs(v).max() for v in _leaves(g_j).values())
        for path in zero_grads:
            for tree in (got, g_j):
                node = tree
                for k in path[:-1]:
                    node = node[k]
                assert np.abs(node[path[-1]]).max() <= 1e-6 * top, path
                node[path[-1]] = np.zeros_like(node[path[-1]])
    _assert_close_scaled(got, g_j, rtol=1e-3, scale_tol=1e-3)
    _assert_close_scaled(export_jax_variables(pm)["batch_stats"], stats_j,
                         rtol=1e-5, scale_tol=1e-5)
    return out


def compare_eval(jm, pm, variables, x, f64=True, out_atol=1e-5, **port_kw):
    """Eval-mode logits on the bridged running statistics."""
    with jax.enable_x64(f64):
        dtype = jnp.float64 if f64 else jnp.float32
        want = np.asarray(jax.jit(lambda v, a: jm.apply(v, a, train=False))(
            variables, jnp.asarray(x, dtype))["logits"])
    load_jax_variables(pm, variables)
    pm.eval()
    with torch.no_grad():
        got = pm(torch.from_numpy(x).to(torch.float64 if f64 else torch.float32),
                 **port_kw)
    np.testing.assert_allclose(got["logits"].numpy(), want, rtol=1e-4,
                               atol=out_atol * np.abs(want).max())
    return got


def to_f64(*modules):
    for m in modules:
        m.to(torch.float64)


def test_osme_resnet18_train_step_and_eval_match_jax():
    x = np.random.RandomState(0).randn(4, 64, 64, 3)
    batch = {"label": np.array([1, 1, 3, 3])}
    jm = JaxOSMENet(num_classes=5, num_attention=2, backbone_name=TINY,
                    dtype=jnp.float64)
    pm = OSMENet(num_classes=5, num_attention=2, backbone_name=TINY,
                 image_size=64, dtype=torch.float64)
    variables = shared_variables(jm, pm, x.shape, 2)
    assert pm.part_fc_0.in_features == 2 * 2 * 512
    to_f64(pm.backbone, pm.osme_0, pm.osme_1)
    compare_eval(jm, pm, variables, x)
    crit = {"lambda_a": 0.5, "use_mamc": True}
    out = compare_train_step(jm, pm, variables, x, JaxMAMCLoss(crit),
                             MAMCLoss(crit), batch, keys=("logits", "parts"))
    assert out["parts"].shape == (4, 2, 1024)


@pytest.mark.parametrize("weighted", [False, True], ids=["all_rows", "padded_rows"])
def test_mamc_loss_matches_jax(weighted):
    rs = np.random.RandomState(3)
    parts = rs.randn(8, 3, 16).astype(np.float32)
    logits = rs.randn(8, 6).astype(np.float32)
    labels = np.array([0, 0, 2, 2, 5, 5, 1, 1])
    batch = {"label": labels}
    if weighted:
        batch["weight"] = np.array([1, 1, 1, 1, 1, 1, 0, 0], np.float32)
    crit = {"lambda_a": 0.5}

    def jax_loss(p, lg):
        return JaxMAMCLoss(crit)({"logits": lg, "parts": p},
                                 {k: jnp.asarray(v) for k, v in batch.items()})

    loss_j, (gp_j, gl_j) = jax.jit(jax.value_and_grad(jax_loss, argnums=(0, 1)))(
        jnp.asarray(parts), jnp.asarray(logits))
    p, lg = (torch.from_numpy(a).requires_grad_() for a in (parts, logits))
    loss = MAMCLoss(crit)({"logits": lg, "parts": p},
                          {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(p.grad.numpy(), gp_j, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(lg.grad.numpy(), gl_j, rtol=1e-4, atol=1e-6)
    if weighted:  # the padded rows take no part: the same as dropping them
        kept = npairs_mamc(torch.from_numpy(parts[:6]), torch.from_numpy(labels[:6]))
        np.testing.assert_allclose(float(npairs_mamc(
            torch.from_numpy(parts), torch.from_numpy(labels),
            torch.from_numpy(batch["weight"]))), float(kept), rtol=1e-6)
