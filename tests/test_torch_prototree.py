"""The port's ProtoTree (hawkeye_tpu_torch/models/methods/prototree.py,
losses/prototree.py) against the JAX package's on the CPU, at the JAX
suite's shapes (tests/test_methods_wave3.py: ResNet-18, 32x32, height 3,
D = 16), from the same perturbed weights (test_torch_osme.perturbed) and
random leaf distributions, bridged.

* eval forward, float32 trunk: ``pred``, ``pa_leaf``, ``leaf_dist`` and the
  logits of all three samplings within 1e-5 of the largest value (rtol
  1e-5); the sample_max and greedy leaves are identical;
* one train-mode step through ProtoTreeLoss with a float64 trunk (the head
  is float32 in both packages): loss rtol 1e-5, outputs as above, every
  gradient rtol 1e-3 / atol 1e-3 of its largest value, the running
  statistics, and ``leaf_update`` on each side's outputs within 1e-6;
* the pieces: ``l2_distances`` with tied positions (values and gradients:
  ``amin`` splits among ties as JAX's min does), ``leaf_path_probs`` and
  ``all_node_path_probs`` in heap order, ``leaf_update``, the weighted
  loss, the bridge's ``tree_leaves`` collection and ``save_tree``/
  ``load_tree``."""

import torch_threads  # noqa: F401  (PyTorch's thread count: see the module)
import copy
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hawkeye_tpu.models  # noqa: F401
from hawkeye_tpu.losses.prototree import ProtoTreeLoss as JaxProtoTreeLoss
from hawkeye_tpu.losses.prototree import leaf_update as jax_leaf_update
from hawkeye_tpu.models.methods import prototree as jpt
from hawkeye_tpu_torch.config import ConfigNode
from hawkeye_tpu_torch.engine import checkpoint as ckpt
from hawkeye_tpu_torch.losses.prototree import ProtoTreeLoss, leaf_update
from hawkeye_tpu_torch.models import export_jax_variables, load_jax_variables
from hawkeye_tpu_torch.models.methods import prototree as ppt
from test_torch_osme import assert_roundtrip, shared_variables
from test_torch_resnet import TINY, _assert_close_scaled, _port_grads
from test_torch_resnet import tiny_trunk  # noqa: F401  (a fixture: pytestmark)

pytestmark = pytest.mark.usefixtures("tiny_trunk")

H, D, C = 3, 16, 4
SAMPLINGS = ("distributed", "sample_max", "greedy")


def _models(dtype_j, dtype_p):
    jm = jpt.ProtoTreeNet(num_classes=C, height=H, num_features=D,
                          backbone_name=TINY, dtype=dtype_j)
    pm = ppt.ProtoTreeNet(C, height=H, num_features=D, backbone_name=TINY,
                          dtype=dtype_p)
    return jm, pm


def _variables(jm, pm, x, seed):
    """Perturbed shared weights; prototypes spread so that the branch
    probabilities straddle 0.5 and the greedy walk turns both ways, and
    random leaves."""
    variables = shared_variables(jm, pm, x.shape, seed)
    probe = copy.deepcopy(load_jax_variables(pm, variables)).eval()
    probe.backbone.to(pm.dtype)
    with torch.no_grad():
        mean = _features(probe, torch.from_numpy(np.asarray(x, np.float32)))
        mean = mean.mean(dim=(0, 1, 2)).numpy()
    rs = np.random.RandomState(seed + 100)
    variables["params"]["prototypes"] = (
        mean + 0.17 * rs.randn(2 ** H - 1, D)).astype(np.float32)
    variables["tree_leaves"] = {"dist_params": rs.randn(2 ** H, C).astype(np.float32)}
    return variables


def _features(pm, x):
    w = pm.neck_conv.weight
    return torch.sigmoid(torch.nn.functional.linear(pm.backbone(x)["c5"].to(w.dtype),
                                                    w.flatten(1)))


def _close(got, want, tol=1e-5, err_msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * np.abs(want).max(),
                               err_msg=err_msg)


def test_eval_forward_all_samplings_match_jax():
    x = np.random.RandomState(0).rand(3, 32, 32, 3).astype(np.float32)
    jm, pm = _models(jnp.float32, torch.float32)
    variables = _variables(jm, pm, x, 1)
    want = jax.device_get(jax.jit(lambda v, a: {s: jm.apply(v, a, train=False, sampling=s)
                                                for s in SAMPLINGS})(variables, x))
    load_jax_variables(pm, variables)
    assert_roundtrip(pm, variables)
    pm.eval()
    with torch.no_grad():
        xt = torch.from_numpy(x)
        got = {s: pm(xt, sampling=s) for s in SAMPLINGS}
        assert torch.equal(pm(xt)["pred"], got["distributed"]["pred"])  # the default
        sims = torch.exp(-ppt.l2_distances(_features(pm, xt), pm.prototypes))
    assert (sims > 0.5).any() and (sims < 0.5).any()
    for s in SAMPLINGS:
        for k in ("logits", "pred", "pa_leaf", "leaf_dist"):
            _close(got[s][k].numpy(), want[s][k], err_msg=f"{s} {k}")
    dist = got["distributed"]["leaf_dist"].numpy()
    for s in ("sample_max", "greedy"):  # one leaf's distribution each, the same leaf
        rows_p = [int(np.abs(dist - r).sum(-1).argmin()) for r in got[s]["pred"].numpy()]
        rows_j = [int(np.abs(np.asarray(want[s]["leaf_dist"]) - r).sum(-1).argmin())
                  for r in np.asarray(want[s]["pred"])]
        assert rows_p == rows_j, s


def test_train_step_matches_jax_f64_trunk():
    x = np.random.RandomState(2).rand(4, 32, 32, 3)
    labels = np.array([0, 3, 1, 3])
    jm, pm = _models(jnp.float64, torch.float64)
    variables = _variables(jm, pm, x, 3)
    leaves = variables["tree_leaves"]["dist_params"]
    old = np.abs(np.random.RandomState(4).randn(2 ** H, C)).astype(np.float32) * 0.1
    with jax.enable_x64(True):
        jbatch = {"label": jnp.asarray(labels)}

        def loss_fn(p):
            out, mut = jm.apply({**variables, "params": p}, jnp.asarray(x), train=True,
                                mutable=["batch_stats"])
            return JaxProtoTreeLoss()(out, jbatch), (out, mut["batch_stats"])

        def step(p):
            (loss, (out, stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
            new = jax_leaf_update(jnp.asarray(leaves), jnp.asarray(old), out["pa_leaf"],
                                  out["leaf_dist"], out["pred"], jbatch["label"], C)
            return loss, out, grads, stats, new

        loss_j, out_j, g_j, stats_j, leaves_j = jax.device_get(
            jax.jit(step)(variables["params"]))
    load_jax_variables(pm, variables)
    pm.backbone.to(torch.float64)  # the head stays float32, as in JAX
    pm.train()
    out = pm(torch.from_numpy(x))
    loss = ProtoTreeLoss()(out, {"label": torch.from_numpy(labels)})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-5)
    for k in ("logits", "pred", "pa_leaf", "leaf_dist"):
        assert out[k].dtype == torch.float32, k
        _close(out[k].detach().numpy(), out_j[k], err_msg=k)
    _assert_close_scaled(_port_grads(pm), g_j, rtol=1e-3, scale_tol=1e-3)
    _assert_close_scaled(export_jax_variables(pm)["batch_stats"], stats_j,
                         rtol=1e-5, scale_tol=1e-6)
    new = leaf_update(pm.dist_params, torch.from_numpy(old), out["pa_leaf"].detach(),
                      out["leaf_dist"].detach(), out["pred"].detach(),
                      torch.from_numpy(labels), C)
    _close(new.numpy(), leaves_j, tol=1e-6)


def test_leaf_update_matches_jax():
    rs = np.random.RandomState(5)
    b, leaves_n = 6, 2 ** H
    pa = rs.dirichlet(np.ones(leaves_n), b).astype(np.float32)
    params = rs.randn(leaves_n, C).astype(np.float32)
    dist = np.array(jax.nn.softmax(params, -1))
    pred = (pa @ dist).astype(np.float32)
    pred[0, 2] = 0.0  # the 1e-12 floor
    labels = np.array([2, 0, 1, 3, 3, 0])
    old = (np.abs(rs.randn(leaves_n, C)) * 0.5).astype(np.float32)
    want = jax_leaf_update(params, old, pa, dist, pred, labels, C)
    got = leaf_update(*(torch.from_numpy(a) for a in (params, old, pa, dist, pred,
                                                      labels)), C)
    _close(got.numpy(), want, tol=1e-6)
    assert (got.numpy() >= 0).all() and float(got[:, 2].max()) > 1e5


@pytest.mark.parametrize("weighted", [False, True])
def test_loss_matches_jax(weighted):
    rs = np.random.RandomState(6)
    logp = np.log(rs.dirichlet(np.ones(C), 5)).astype(np.float32)
    batch = {"label": np.array([0, 1, 3, 2, 1])}
    if weighted:
        batch["weight"] = np.array([1, 1, 0, 1, 0], np.float32)
    want = JaxProtoTreeLoss()({"logits": jnp.asarray(logp)},
                              {k: jnp.asarray(v) for k, v in batch.items()})
    got = ProtoTreeLoss()({"logits": torch.from_numpy(logp)},
                          {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_l2_distances_split_ties_like_jax():
    rs = np.random.RandomState(7)
    f = rs.rand(2, 2, 2, D).astype(np.float32)
    f[:, 1, 1] = f[:, 0, 0]  # two positions tie for every prototype's min
    f[:, 0, 1] = f[:, 1, 0] = 5.0
    protos = rs.rand(5, D).astype(np.float32)
    w = rs.randn(2, 5).astype(np.float32)

    def jax_obj(feat, p):
        return (jpt.l2_distances(feat, p) * w).sum()

    want = jpt.l2_distances(f, protos)
    gf_j, gp_j = jax.grad(jax_obj, argnums=(0, 1))(f, protos)
    ft, pt = (torch.from_numpy(a).requires_grad_() for a in (f, protos))
    got = ppt.l2_distances(ft, pt)
    (got * torch.from_numpy(w)).sum().backward()
    _close(got.detach().numpy(), want, tol=1e-6)
    _close(ft.grad.numpy(), gf_j, tol=1e-5)
    _close(pt.grad.numpy(), gp_j, tol=1e-5)
    np.testing.assert_allclose(ft.grad[:, 0, 0].numpy(), ft.grad[:, 1, 1].numpy())


def test_path_probs_keep_heap_order():
    ps = np.random.RandomState(8).rand(3, 2 ** 4 - 1).astype(np.float32)
    for port_fn, jax_fn in ((ppt.leaf_path_probs, jpt.leaf_path_probs),
                            (ppt.all_node_path_probs, jpt.all_node_path_probs)):
        _close(port_fn(torch.from_numpy(ps), 4).numpy(), jax_fn(jnp.asarray(ps), 4),
               tol=1e-6)
    pa = ppt.leaf_path_probs(torch.from_numpy(ps), 4)
    # leaf 0 is left at every level (heap slot 15), the last leaf right
    np.testing.assert_allclose(pa[:, 0].numpy(), np.prod(1 - ps[:, [0, 1, 3, 7]], 1),
                               rtol=1e-6)
    np.testing.assert_allclose(pa[:, -1].numpy(), np.prod(ps[:, [0, 2, 6, 14]], 1),
                               rtol=1e-6)


def test_init_and_tree_leaves_collection(tmp_path):
    """``neck_conv`` is xavier-normal (fan_avg), ``prototypes`` 0.5 + 0.1 N,
    the leaves zero; the leaves go through the bridge as flax's
    ``tree_leaves`` (not ``batch_stats``) and through the saved model."""
    from hawkeye_tpu_torch.models import init_parameters

    cfg = ConfigNode({"num_classes": 200, "height": 5, "num_features": 256,
                      "backbone": {"name": "resnet18"}})
    pm = ppt.build_prototree(cfg)
    init_parameters(pm, torch.Generator().manual_seed(9))
    w = pm.neck_conv.weight
    np.testing.assert_allclose(float(w.detach().std()), (2.0 / (512 + 256)) ** 0.5, rtol=0.05)
    assert float(w.abs().max()) <= 2 * (2.0 / (512 + 256)) ** 0.5 / 0.8796 + 1e-6
    assert abs(float(pm.prototypes.mean()) - 0.5) < 0.01
    np.testing.assert_allclose(float(pm.prototypes.std()), 0.1, rtol=0.05)
    assert not pm.dist_params.any() and pm.dist_params.shape == (32, 200)
    assert "dist_params" not in dict(pm.named_parameters())
    tree = export_jax_variables(pm)
    assert tree["tree_leaves"]["dist_params"].shape == (32, 200)
    assert "dist_params" not in tree["batch_stats"] and "dist_params" not in tree["params"]
    leaves = np.random.RandomState(10).randn(32, 200).astype(np.float32)
    load_jax_variables(pm, {**tree, "tree_leaves": {"dist_params": leaves}})
    np.testing.assert_array_equal(pm.dist_params.numpy(), leaves)
    ckpt.save_model(str(tmp_path / "m.msgpack"), pm)
    fresh = ppt.build_prototree(cfg)
    ckpt.load_model(str(tmp_path / "m.msgpack"), fresh)
    np.testing.assert_array_equal(fresh.dist_params.numpy(), leaves)


def test_save_and_load_tree(tmp_path):
    xn = np.random.RandomState(11).rand(2, 32, 32, 3).astype(np.float32)
    x = torch.from_numpy(xn)
    jm, pm = _models(jnp.float32, torch.float32)
    variables = _variables(jm, pm, xn, 12)
    load_jax_variables(pm, variables)
    pm.eval_sampling = "greedy"
    ppt.save_tree(str(tmp_path / "tree"), pm.eval())
    jpt.save_tree(str(tmp_path / "jax_tree"), jm.clone(eval_sampling="greedy"),
                  variables)
    with open(tmp_path / "tree" / "tree.json") as f, \
            open(tmp_path / "jax_tree" / "tree.json") as g:
        meta = json.load(f)
        assert meta == json.load(g)
    assert sorted(os.listdir(tmp_path / "tree")) == ["tree.json", "tree.pt"]
    loaded = ppt.load_tree(str(tmp_path / "tree")).eval()
    assert loaded.eval_sampling == "greedy" and loaded.dtype == torch.float32
    with torch.no_grad():
        for s in SAMPLINGS:
            assert torch.equal(loaded(x, sampling=s)["logits"], pm(x, sampling=s)["logits"])
