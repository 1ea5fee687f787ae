"""The port's NMS (hawkeye_tpu_torch/ops/nms.py), multi-box crop
(ops/resample.py ``crop_resize_multibox``) and per-group BatchNorm
(models/backbones/norm.py ``GroupedBatchNorm``, the ResNet's ``bn_groups``)
against the JAX package's on the CPU.

NMS: picks and their scores identical (they are indices and gathers) on
float32 score rows with exact ties (the first of equal maxima wins in both),
rows that run out of boxes (their slots take the row's best), rows of
``-inf`` and rows with ``-inf`` entries; the adjacency from the port's own
numpy copy equal to JAX's; ``iou_matrix`` rtol 1e-6 in float32;
``nms_general``'s indices, scores and mask identical.

``crop_resize_multibox``: float32 images, boxes partly outside the image,
both ``align_corners``, against the jitted JAX function (XLA computes the
sample coordinates with a fused multiply-add and a float32 reciprocal,
and so does the port); within 1e-6 of the largest value (float32 weights
and products in both; JAX asks its products for float32 results, so its
float64 crop is float32-rounded too).

``GroupedBatchNorm`` in float64 with ``groups`` and ``group_sizes``: the
output and the input's gradient for a random linear function of it within
1e-10 of each tensor's largest value, the scale's and bias's within 1e-6
(JAX's are float32, as its parameters), the running statistics
folded group by group within 1e-6 (the JAX fold multiplies by a float32
momentum, and the first group's product is float32 where the statistics
start as float32); with one group it is ``BatchNorm``. A ResNet-18 train
forward with ``bn_groups=(B, B*M)`` against JAX's ``grouped_bn`` ResNet:
stages within 1e-8, statistics within 1e-6.
"""

import torch_threads  # noqa: F401  (PyTorch's thread count: see the module)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hawkeye_tpu.models  # noqa: F401
import hawkeye_tpu_torch.models  # noqa: F401
from hawkeye_tpu.models.backbones.norm import GroupedBatchNorm as JaxGroupedBN
from hawkeye_tpu.ops import nms as jax_nms
from hawkeye_tpu.ops.resample import crop_resize_multibox as jax_multibox
from hawkeye_tpu.registry import BACKBONE as JAX_BACKBONE
from hawkeye_tpu_torch import BACKBONE
from hawkeye_tpu_torch.models import bridge, export_jax_variables, load_jax_variables
from hawkeye_tpu_torch.models.backbones.norm import BatchNorm, GroupedBatchNorm
from hawkeye_tpu_torch.ops import nms
from hawkeye_tpu_torch.ops.resample import crop_resize_multibox
from test_torch_resnet import _assert_close_scaled, _with_stats


def stats64(module):
    """The module's BatchNorm statistics as a flax ``batch_stats`` tree, in
    float64 (the bridge exports float32)."""
    tree = {}
    for (collection, path), (_, t) in bridge._name_map(module).items():
        if collection == "batch_stats":
            node = tree
            for seg in path[:-1]:
                node = node.setdefault(seg, {})
            node[path[-1]] = t.detach().double().numpy()
    return tree


def _score_rows(rs, a):
    """Rows of [B, A] float32 scores: coarse values with many exact ties, a
    row of -inf, a row with -inf entries, a constant row."""
    s = rs.randint(0, 6, (6, a)).astype(np.float32)
    s[1] = -np.inf
    s[2, rs.rand(a) < 0.6] = -np.inf
    s[3] = 2.0
    s[4] = rs.randn(a).astype(np.float32)
    return s


@pytest.mark.parametrize("density", [0.15, 0.6], ids=["sparse", "dense_exhausts"])
def test_nms_fixed_anchors_matches_jax(density):
    rs = np.random.RandomState(0)
    a, topn = 24, 7
    adj = rs.rand(a, a) < density
    adj = adj | adj.T | np.eye(a, dtype=bool)
    scores = _score_rows(rs, a)
    want_i, want_v = jax_nms.nms_fixed_anchors_batch(jnp.asarray(scores),
                                                     jnp.asarray(adj), topn)
    got_i, got_v = nms.nms_fixed_anchors_batch(torch.from_numpy(scores),
                                               torch.from_numpy(adj), topn)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    one_i, one_v = nms.nms_fixed_anchors(torch.from_numpy(scores[4]),
                                         torch.from_numpy(adj), topn)
    np.testing.assert_array_equal(one_i.numpy(), np.asarray(want_i[4]))
    np.testing.assert_array_equal(one_v.numpy(), np.asarray(want_v[4]))
    assert (got_i[1] == 0).all()  # a row of -inf: every slot index 0
    if density > 0.5:  # some row ran out and its slots repeat its best
        best = torch.from_numpy(scores).argmax(1, keepdim=True)
        assert (got_i[:, 1:] == best).any()


def test_anchor_adjacency_and_iou_match_jax():
    rs = np.random.RandomState(1)
    y0x0 = rs.uniform(-20, 100, (30, 2))
    boxes = np.concatenate([y0x0, y0x0 + rs.uniform(5, 60, (30, 2))], 1).astype(np.float32)
    for thresh in (0.05, 0.25):
        np.testing.assert_array_equal(nms.anchor_adjacency(boxes, thresh),
                                      jax_nms.anchor_adjacency(boxes, thresh))
    np.testing.assert_allclose(
        nms.iou_matrix(torch.from_numpy(boxes), torch.from_numpy(boxes[:7])).numpy(),
        np.asarray(jax_nms.iou_matrix(jnp.asarray(boxes), jnp.asarray(boxes[:7]))),
        rtol=1e-6, atol=1e-7)
    scores = rs.randint(0, 4, 30).astype(np.float32)
    for topn in (5, 30):  # the second runs out: exhausted slots are masked
        want = jax_nms.nms_general(jnp.asarray(scores), jnp.asarray(boxes), topn, 0.2)
        got = nms.nms_general(torch.from_numpy(scores), torch.from_numpy(boxes), topn, 0.2)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert not bool(got[2].all())


@pytest.mark.parametrize("align_corners", [False, True])
def test_crop_resize_multibox_matches_jax(align_corners):
    rs = np.random.RandomState(2)
    img = rs.randn(2, 20, 24, 3).astype(np.float32)
    y0x0 = rs.uniform(-6, 16, (2, 3, 2))
    hw = rs.uniform(3, 18, (2, 3, 2))
    boxes = np.concatenate([y0x0, hw], -1).astype(np.float32)
    want = np.asarray(jax.jit(jax_multibox, static_argnums=(2, 3, 4, 5))(
        jnp.asarray(img), jnp.asarray(boxes), 9, 7, None, align_corners))
    got = crop_resize_multibox(torch.from_numpy(img), torch.from_numpy(boxes), 9, 7,
                               align_corners=align_corners)
    assert got.shape == (2, 3, 9, 7, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())


def _flax_bn_vars(rs, c):
    return {"params": {"scale": (1 + 0.3 * rs.randn(c)).astype(np.float32),
                       "bias": (0.1 * rs.randn(c)).astype(np.float32)},
            "batch_stats": {"mean": (0.1 * rs.randn(c)).astype(np.float32),
                            "var": rs.uniform(0.8, 1.25, c).astype(np.float32)}}


@pytest.mark.parametrize("spec", [2, (2, 6), 1], ids=["groups2", "sizes_2_6", "one_group"])
def test_grouped_batchnorm_matches_jax(spec):
    rs = np.random.RandomState(3)
    x = rs.randn(8, 3, 3, 5) * 2 + 1
    ct = rs.randn(*x.shape)  # the linear function's coefficients
    variables = _flax_bn_vars(rs, 5)
    by_sizes = isinstance(spec, tuple)
    ref = JaxGroupedBN(groups=1 if by_sizes else spec,
                       group_sizes=spec if by_sizes else None)
    with jax.enable_x64(True):
        def f(p, xx):
            y, mut = ref.apply({"params": p, "batch_stats": variables["batch_stats"]},
                               xx, mutable=["batch_stats"])
            return (y * ct).sum(), (y, mut["batch_stats"])

        (_, (y_j, stats_j)), (gp_j, gx_j) = jax.device_get(jax.jit(jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True))(variables["params"], jnp.asarray(x)))

    bn = GroupedBatchNorm(5).double()
    load_jax_variables(bn, variables)
    bn.groups = spec
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last).requires_grad_()
    y = bn.train()(xt).permute(0, 2, 3, 1)
    (y * torch.from_numpy(ct)).sum().backward()
    scale = np.abs(y_j).max()
    np.testing.assert_allclose(y.detach().numpy(), y_j, rtol=0, atol=1e-10 * scale)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), gx_j, rtol=0,
                               atol=1e-10 * np.abs(gx_j).max())
    _assert_close_scaled(stats64(bn), stats_j, rtol=0, scale_tol=1e-6)
    for n, p in (("scale", bn.weight), ("bias", bn.bias)):
        np.testing.assert_allclose(p.grad.numpy(), gp_j[n], rtol=0,
                                   atol=1e-6 * np.abs(gp_j[n]).max())
    if spec == 1:  # one group: BatchNorm itself, with the same buffers
        plain = BatchNorm(5).double()
        load_jax_variables(plain, variables)
        assert dict(plain.state_dict()).keys() == dict(bn.state_dict()).keys()
        with torch.no_grad():
            torch.testing.assert_close(plain.train()(xt), y.permute(0, 3, 1, 2),
                                       rtol=0, atol=0)


def test_resnet_bn_groups_matches_jax_grouped_bn():
    x = np.random.RandomState(4).randn(6, 32, 32, 3)
    jm = JAX_BACKBONE.get("resnet18")(num_classes=0, dtype=jnp.float64, grouped_bn=True)
    pm = BACKBONE.get("resnet18")(num_classes=0, dtype=torch.float64, grouped_bn=True)
    variables = _with_stats(export_jax_variables(pm), 5)
    with jax.enable_x64(True):
        out, mut = jax.jit(lambda v, a: jm.apply(v, a, train=True, bn_groups=(2, 4),
                                                 mutable=["batch_stats"]))(
            variables, jnp.asarray(x))
        out, mut = jax.device_get((out, mut))
    load_jax_variables(pm, variables)
    pm.double().train()
    with torch.no_grad():
        got = pm(torch.from_numpy(x), bn_groups=(2, 4))
    for k in ("c3", "c5"):
        np.testing.assert_allclose(got[k].numpy(), out[k], rtol=0,
                                   atol=1e-8 * np.abs(out[k]).max(), err_msg=k)
    _assert_close_scaled(stats64(pm), mut["batch_stats"], rtol=0, scale_tol=1e-6)
    plain = BACKBONE.get("resnet18")(num_classes=0)
    with pytest.raises(ValueError, match="grouped_bn"):
        plain(torch.zeros(2, 32, 32, 3), bn_groups=2)
