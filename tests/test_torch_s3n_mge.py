"""The port's S3N and MGE-CNN against the JAX package's on the CPU.

S3N (hawkeye_tpu_torch/ops/peaks.py, models/methods/s3n.py,
losses/s3n.py):

The peak mask on maps with plateaus (ties), identical; the peak mean and its
gradient rtol 1e-6. The saliency, the blur (with its kernel's gradient), the
grid and the decided map on random float32 inputs: values rtol 1e-5 with an
atol of 1e-5 of the largest value (float32 sums in another order; the blur
kernel's gradient 1e-4), the decided map at a crafted tie of the 5th and
6th class probabilities, which both packages break towards the lower index.
The full-image resize weights bit-equal to the jitted JAX function's at the
slice's shapes (XLA folds the JAX package's constant boxes: see
``hawkeye_tpu_torch/ops/resample.py``).

The model: resnet18 trunk at 64x64, 5 classes, batch 2, the port's init
with every BatchNorm scale and bias at random (the radii at the recipe's
values), in float64 throughout on both sides. The JAX package computes the
class map, the saliency and the grids in float32 whatever the trunk's
dtype, and a float32 grid moves the warped views by ~1e-5 of a pixel
spacing, which train-mode BatchNorm over 2 images turns into differences of
0.1-0.2 of a gradient's largest value between two right implementations
(the port's own float32 and float64 runs differ as much). So the JAX module
reads float32 as float64 here (``_Float64Numpy``), its resizes sum in
float64 on its own weights (``_resize_float64``) and its blur is one
convolution (``_conv_blur``; the unit test above holds its Toeplitz form).
One compiled JAX program gives the eval forward at phase 0 on the model's
own class map and at phases 1 (U's draws fed to both) and 2 on SCORE's
many peaks: the four heads within 1e-7 of their largest value (the JAX
trunk's pooled feature is float32) and the zoom and inverse peak masks
identical. The train step, at phase 1, is held through both packages'
Example trainers in test_torch_examples_s3n_mge.py (gradients, through the
updates, and running statistics). The port's two-pass form against its
fused pass at 1e-10, a train step at phase 1. The port's own draws come
import torch_threads  # noqa: F401  (PyTorch's thread count: see the module)
from the caller's generator, and none from the global RNG.

The loss alone: random heads with and without a per-sample weight, values
rtol 1e-5, gradients rtol 1e-4 / atol 1e-6.

MGE-CNN (models/methods/mge.py, losses/mge.py):

``cam_bbox`` on random maps, one of them all zero (a constant CAM: no
position above the threshold, so the box falls back to the whole image):
the boxes identical to the jitted JAX function's (their edges are
thresholded positions of a resized map, so the resize weights must be
XLA's to the bit), the crops rtol 1e-6 with an atol of 1e-6 of the largest
value.

The model: resnet18 trunks at 64x64, 5 classes, batch 2, the port's init
with every BatchNorm scale and bias at random; the trunks in float64 on
both sides, the heads float32 in both packages. One compiled JAX program
gives the eval forward (each expert's argmax picks its CAM's class):
``logits``, ``all_logits`` and ``pr_gate`` within 1e-6 of their largest
value, and the two crop boxes per image identical. The train step with the
labels is held in test_torch_examples_s3n_mge.py, through both packages'
Example trainers.

The loss alone: random [10, B, C] heads with and without a per-sample
weight, values rtol 1e-5, gradients rtol 1e-4 / atol 1e-6. The JAX
package's ``fused_experts`` is not ported: asking for it raises.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hawkeye_tpu.models  # noqa: F401
from hawkeye_tpu.losses.mge import MGELoss as JaxMGELoss
from hawkeye_tpu.losses.s3n import MultiSmoothLoss as JaxMultiSmoothLoss
from hawkeye_tpu.models.methods import mge as jax_mge
from hawkeye_tpu.models.methods import s3n as jax_s3n
from hawkeye_tpu.ops import peaks as jax_peaks
from hawkeye_tpu.ops import resample as jax_resample
from hawkeye_tpu_torch.config import ConfigNode
from hawkeye_tpu_torch.losses.mge import MGELoss
from hawkeye_tpu_torch.losses.s3n import MultiSmoothLoss
from hawkeye_tpu_torch.models import export_jax_variables, load_jax_variables
from hawkeye_tpu_torch.models.methods import mge, s3n
from hawkeye_tpu_torch.ops import peaks, resample
from test_torch_osme import perturbed
from test_torch_region_ops import stats64
from test_torch_resnet import _assert_close_scaled, init_in_float32

KW = dict(num_classes=5, image_size=64, backbone_name="resnet18")
HEADS = ("logits", "agg_origin", "agg_sampler", "agg_sampler1")
# phase 1's uniform draws, for up to 8 images
U = np.random.RandomState(11).rand(8, 31, 31).astype(np.float32)
# a decided score map with many peaks, min-max normalised as the model's
SCORE = np.random.RandomState(12).rand(8, 31, 31).astype(np.float32)
SCORE = (SCORE - SCORE.min(axis=(1, 2), keepdims=True)) / np.ptp(SCORE, axis=(1, 2),
                                                                  keepdims=True)


def _close(got, want, rtol=1e-5, scale=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=scale * np.abs(want).max())


@pytest.mark.parametrize("mean_filter", [True, False], ids=["mean_filter", "max_only"])
def test_peak_mask_and_stimulation_match_jax(mean_filter):
    rs = np.random.RandomState(0)
    x = np.round(rs.rand(3, 2, 9, 11) * 4).astype(np.float32) / 4  # plateaus
    r = rs.randn(3, 2).astype(np.float32)

    want_mask = jax_peaks.peak_mask(jnp.asarray(x), 3, mean_filter)
    _, want_agg = jax_peaks.peak_stimulation(jnp.asarray(x), 3, mean_filter)

    def agg_sum(v):
        # the JAX package's reduce_window has no derivative: its aggregation
        # with the mask held constant, which its stop_gradient does
        m = want_mask.astype(v.dtype)
        return ((v * m).sum(axis=(-2, -1)) / jnp.maximum(m.sum(axis=(-2, -1)), 1e-6)
                * r).sum()

    want_grad = jax.jit(jax.grad(agg_sum))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    mask, agg = peaks.peak_stimulation(xt, 3, mean_filter)
    (agg * torch.from_numpy(r)).sum().backward()
    np.testing.assert_array_equal(mask.numpy(), np.asarray(want_mask))
    np.testing.assert_array_equal(peaks.peak_mask(xt.detach(), 3, mean_filter).numpy(),
                                  np.asarray(want_mask))
    assert 1 < mask.sum() < mask.numel() // 2
    np.testing.assert_allclose(agg.detach().numpy(), np.asarray(want_agg), rtol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_grad), rtol=1e-6)
    with pytest.raises(ValueError, match="odd"):
        peaks.peak_mask(xt, 4)


@pytest.mark.parametrize("weight_by", ["score", "inv"])
def test_saliency_from_peaks_matches_jax(weight_by):
    rs = np.random.RandomState(1)
    score = rs.rand(2, 31, 31).astype(np.float32)
    mask = score > 0.8
    theta = (0.12 * np.sqrt(score)).astype(np.float32)
    want = jax.jit(lambda s, m, t: jax_s3n.saliency_from_peaks(s, m, t, 0.09, weight_by))(
        score, mask, theta)
    got = s3n.saliency_from_peaks(torch.from_numpy(score), torch.from_numpy(mask),
                                  torch.from_numpy(theta), 0.09, weight_by)
    _close(got.numpy(), want)


@pytest.mark.parametrize("size_in,size_out,align", [
    (2, 31, True), (14, 31, True), (31, 64, True), (31, 448, True), (7, 224, True),
    (64, 224, False), (512, 448, False)])
def test_full_image_resize_weights_match_jitted_jax(size_in, size_out, align):
    """S3N's and MGE-CNN's resizes (the 2x2 and 14x14 class maps to 31, the
    grid to 64 and 448, the 7x7 CAM to 224; and two of ``align_corners``
    False): the JAX package's full-image boxes are constants that XLA folds,
    and the port's weights are bit-equal to the folded ones."""
    want = jax.jit(lambda: jax_resample.resize_bilinear(
        jnp.eye(size_in, dtype=jnp.float32)[None, :, :, None], size_out, size_in,
        align_corners=align))()
    got = resample.resize_bilinear(torch.eye(size_in)[None, :, :, None], size_out, size_in,
                                   align_corners=align)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _jax_model(**kw):
    return jax_s3n.S3N(dtype=jnp.float64, **{**KW, **kw})


def test_blur_grid_and_decided_map_match_jax():
    """``_blur`` (and its kernel's gradient), ``_create_grid`` and
    ``_decide_map`` with a tie at the 5th probability."""
    pm = s3n.S3N(dtype=torch.float64, **KW)
    jm = _jax_model()
    rs = np.random.RandomState(2)
    kernel = (s3n._gaussian_2d(61) * (1 + 0.1 * rs.randn(61, 61))).astype(np.float32)
    params = {"params": {"blur_kernel": kernel[..., None, None]}}
    sal = (0.09 + rs.rand(2, 31, 31)).astype(np.float32)
    r = rs.randn(2, 64, 64, 2).astype(np.float32)

    def grid_sum(k, s):
        grid = jm.apply({"params": {"blur_kernel": k}}, s, method=jax_s3n.S3N._create_grid)
        return (grid * r).sum(), grid

    (_, want_grid), want_dk = jax.jit(jax.value_and_grad(grid_sum, has_aux=True))(
        kernel[..., None, None], sal)
    padded = rs.rand(3, 91, 91).astype(np.float32)
    want_blur = jax.jit(lambda p, x: jm.apply(p, x, method=jax_s3n.S3N._blur))(params, padded)

    with torch.no_grad():
        pm.blur_kernel.copy_(torch.from_numpy(kernel[..., None, None]))
    _close(pm._blur(torch.from_numpy(padded)).detach().numpy(), want_blur)
    grid = pm._create_grid(torch.from_numpy(sal))
    (grid * torch.from_numpy(r)).sum().backward()
    _close(grid.detach().numpy(), want_grid)
    _close(pm.blur_kernel.grad.numpy(), want_dk, rtol=1e-4, scale=1e-4)

    # class maps whose spatial means are exact: 4 distinct leaders, then
    # classes 5 and 7 tied for the 5th place
    crm = np.zeros((2, 31, 31, 8), np.float32)
    means = np.array([0.0, 3.0, 2.5, 2.0, 1.5, 1.0, 0.5, 1.0], np.float32)
    pattern = np.round(rs.randn(31, 31, 8) * 8) / 8
    pattern -= pattern[::-1, ::-1]  # point-symmetric pairs: sums exactly 0
    crm[:] = means + np.where(np.arange(8) >= 5, pattern, 0.0)
    crm[1] *= 4.0  # a peaked softmax: the gate picks the top map
    want = jax.jit(lambda c: jm.apply(params, c, method=jax_s3n.S3N._decide_map))(crm)
    got = pm._decide_map(torch.from_numpy(crm))
    _close(got.numpy(), want)
    # with class 7 in place of class 5 the mean of the top five would differ
    swapped = crm.copy()
    swapped[..., [5, 7]] = crm[..., [7, 5]]
    assert not np.allclose(pm._decide_map(torch.from_numpy(swapped))[0].numpy(),
                           got[0].numpy())


def _fixed_uniform():
    """``jax`` for the JAX S3N module, whose uniform draws are U."""
    return types.SimpleNamespace(
        lax=jax.lax, nn=jax.nn,
        random=types.SimpleNamespace(uniform=lambda key, shape: jnp.asarray(U[:shape[0]])))


def _recording_saliency(seen):
    real = jax_s3n.saliency_from_peaks

    def record(score, mask, theta, base, weight_by):
        jax.debug.callback(lambda m, w=weight_by: seen.append((w, np.asarray(m))), mask)
        return real(score, mask, theta, base, weight_by)

    return record


class _Float64Numpy:
    """``jax.numpy`` for the JAX S3N module, with its float32 read as
    float64: its classifiers, the class response map and the map-to-grid
    path then compute in float64, as the port's model cast to float64."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@functools.lru_cache(maxsize=None)
def _weights(in_size, out_size):
    """The JAX package's ``align_corners`` resize weights [out, in], as its
    jitted function computes them outside float64 mode (there, XLA forms the
    float32 coordinates otherwise, an ulp apart), in float64; made before a
    float64 trace reads them."""
    w = jax.jit(lambda: jax_resample._bilinear_weights(
        jnp.zeros((1,)), jnp.full((1,), float(in_size)), in_size, out_size, jnp.float32,
        align_corners=True))()
    return np.asarray(w[0], np.float64)


def _resize_float64(images, out_h, out_w, dtype=None, align_corners=False):
    """The JAX package's ``resize_bilinear`` (rows first, then columns) with
    float64 sums: its own rounds each product to float32."""
    wy = _weights(images.shape[1], out_h)
    wx = _weights(images.shape[2], out_w)
    return jnp.einsum("pw,bowc->bopc", wx, jnp.einsum("oh,bhwc->bowc", wy, images))


def port_variables(pm, seed):
    """The port's init of ``pm`` (drawn in float32: ``init_in_float32``),
    perturbed, in the flax layout."""
    return perturbed(export_jax_variables(init_in_float32(pm, seed)), seed)


def port(fused=True):
    return s3n.S3N(dtype=torch.float64, fused_warp_pass=fused, **KW).double()


@functools.lru_cache(maxsize=None)
def s3n_variables(seed):
    """The port's perturbed init of ``port()``, with the radii at their
    initial values, in float64 (the JAX blur computes in its kernel's
    dtype); shared, not to be changed."""
    variables = port_variables(port(), seed)
    for name, value in (("radius", 0.12), ("radius_inv", 0.3)):
        variables["params"][name]["scale"] = np.array([value], np.float32)
    return jax.tree.map(lambda a: np.asarray(a, np.float64), variables)


def _conv_blur(self, x):
    """The JAX S3N's ``_blur`` as one convolution: the same valid
    correlation with ``blur_kernel`` as its Toeplitz contraction
    (``test_blur_grid_and_decided_map_match_jax`` holds the two packages'
    blurs together), and a smaller program to compile."""
    out = jax.lax.conv_general_dilated(x[..., None].astype(self.blur_kernel.dtype),
                                       self.blur_kernel, (1, 1), "VALID",
                                       dimension_numbers=("NHWC", "HWIO", "NHWC"))
    return out[..., 0]


def recorded_peaks(pm):
    seen = []
    real = pm._peaks

    def record(score_map, p, u):
        seen.append(real(score_map, p, u))
        return seen[-1]

    pm._peaks = record
    return seen


def float64_jax_s3n(monkeypatch, seen=None):
    """The JAX S3N module in float64 throughout (``_Float64Numpy``,
    ``_resize_float64``, ``_conv_blur``), its uniform draws U, and its
    zoom and inverse peak masks recorded in ``seen``."""
    monkeypatch.setattr(jax_s3n, "jax", _fixed_uniform())
    monkeypatch.setattr(jax_s3n, "jnp", _Float64Numpy())
    monkeypatch.setattr(jax_s3n, "resize_bilinear", _resize_float64)
    for sizes in ((2, 31), (31, 64)):  # the 2x2 class maps, the grids at 64x64
        _weights(*sizes)
    monkeypatch.setattr(jax_s3n.S3N, "_blur", _conv_blur)
    if seen is not None:
        monkeypatch.setattr(jax_s3n, "saliency_from_peaks", _recording_saliency(seen))


def with_many_peaks(monkeypatch, *port_models):
    """Both packages' decided map replaced by SCORE, a map with many peaks."""
    monkeypatch.setattr(jax_s3n.S3N, "_decide_map",
                        lambda self, crm: jnp.asarray(SCORE[:crm.shape[0]], jnp.float64))
    for pm in port_models:
        pm._decide_map = lambda crm: torch.from_numpy(SCORE[:crm.shape[0]]).double()


def port_masks(seen):
    """The port's recorded (zoom, inverse) masks as sorted (kind, bytes)."""
    return sorted((w, m.numpy().tobytes()) for z, i in seen
                  for w, m in (("score", z), ("inv", i)))


def jax_masks(seen):
    """The JAX module's recorded (kind, mask) pairs, sorted alike."""
    return sorted((w, np.asarray(m).tobytes()) for w, m in seen)


def test_s3n_eval_forward_at_each_phase_matches_jax(monkeypatch):
    """One compiled JAX program gives the eval forward at phase 0 on the
    model's own class map, and at phases 1 (U's draws) and 2 on SCORE's
    many peaks: the four heads and the peak masks of each. The train step
    (phase 1) is held through both packages' Example trainers in
    test_torch_examples_s3n_mge.py."""
    seen_jax = []
    float64_jax_s3n(monkeypatch, seen_jax)
    real_decide = jax_s3n.S3N._decide_map
    patched = []  # set while the phases 1 and 2 are traced

    def decide(self, crm):
        if patched:
            return jnp.asarray(SCORE[:crm.shape[0]], jnp.float64)
        return real_decide(self, crm)

    monkeypatch.setattr(jax_s3n.S3N, "_decide_map", decide)
    variables = s3n_variables(5)
    x = np.random.RandomState(6).rand(2, 64, 64, 3) * 2 - 1

    def forwards(v, xx):
        rngs = {"dropout": jax.random.PRNGKey(0)}
        out = [_jax_model().apply(v, xx, train=False, p=0, rngs=rngs)]
        patched.append(True)
        out += [_jax_model().apply(v, xx, train=False, p=p, rngs=rngs) for p in (1, 2)]
        patched.clear()
        return out

    with jax.enable_x64(True):
        want = jax.device_get(jax.jit(forwards)(variables, jnp.asarray(x)))
    pm = port()
    load_jax_variables(pm, variables)
    seen = recorded_peaks(pm)
    for p, ref in enumerate(want):
        if p == 1:
            pm._decide_map = lambda crm: torch.from_numpy(SCORE[:crm.shape[0]]).double()
        with torch.no_grad():
            got = pm.eval()(torch.from_numpy(x), p=p, u=torch.from_numpy(U[:2]))
        for k in HEADS:
            w = np.asarray(ref[k])
            np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                       atol=1e-7 * np.abs(w).max(), err_msg=f"p={p} {k}")
    # (the JAX program's callbacks come in either order)
    assert port_masks(seen) == jax_masks(seen_jax)
    (z0, i0), (z1, i1), (z2, i2) = seen
    assert z0.sum() >= 2 and torch.equal(z0, i0)
    assert (z1 & i1).sum() == 0 and z1.sum() >= 20 and i1.sum() >= 20  # split by U
    assert z2.sum() == i2.sum() == 2 and not (z2 & i2).any()  # highest, lowest


def test_s3n_fused_warp_pass_equals_two_passes(monkeypatch):
    """The port's one 2B backbone call with per-view statistics against its
    two B calls: outputs, gradients and running statistics (zoom folded
    first), float64, a train step at phase 1 on SCORE (chip_smoke.py holds
    the two forms together on the card at every phase)."""
    p = 1
    fused, two_pass = port(), port(fused=False)
    with_many_peaks(monkeypatch, fused, two_pass)
    variables = s3n_variables(5)
    x = torch.from_numpy(np.random.RandomState(8).rand(2, 64, 64, 3) * 2 - 1)
    y = {"label": torch.tensor([0, 3])}
    outs = []
    for pm in (fused, two_pass):
        load_jax_variables(pm, variables)
        outs.append(pm.train()(x, p=p, u=torch.from_numpy(U[:2])))
        MultiSmoothLoss()(outs[-1], y).backward()
    for k in HEADS:
        torch.testing.assert_close(outs[1][k], outs[0][k], rtol=0, atol=1e-10)
    grads = dict(fused.named_parameters())
    for n, prm in two_pass.named_parameters():
        torch.testing.assert_close(prm.grad, grads[n].grad, rtol=1e-10, atol=1e-10, msg=n)
    _assert_close_scaled(stats64(two_pass), stats64(fused), rtol=0, scale_tol=1e-12)


def test_s3n_on_a_vgg_trunk_is_not_ported():
    """The JAX S3N reads its trunk's ``c5``, which a VGG trunk does not give
    (a KeyError there); the port says so when it is built."""
    cfg = ConfigNode({"name": "S3N", "num_classes": 5, "backbone": "vgg16"}).freeze()
    with pytest.raises(NotImplementedError, match="model.backbone: vgg16"):
        s3n.build_s3n(cfg)


def test_s3n_draws_from_the_callers_generator():
    pm = s3n.S3N(dtype=torch.float32, **dict(KW, image_size=64)).train()
    x = torch.rand(2, 64, 64, 3, generator=torch.Generator().manual_seed(1))
    with pytest.raises(ValueError, match="generator"):
        pm(x, p=1)
    state = torch.random.get_rng_state()
    a = pm(x, p=1, generator=torch.Generator().manual_seed(7))["logits"]
    b = pm(x, p=1, u=pm.uniform_draws(torch.Generator().manual_seed(7), 2))["logits"]
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert torch.equal(torch.random.get_rng_state(), state)


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
def test_multismooth_loss_matches_jax(weighted):
    rs = np.random.RandomState(8)
    heads = [rs.randn(6, 5).astype(np.float32) for _ in HEADS]
    batch = {"label": rs.randint(0, 5, 6)}
    if weighted:
        batch["weight"] = np.array([1, 0, 1, 1, 0, 1], np.float32)
    cfg = {"smooth_ratio": 0.7}
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda *h: JaxMultiSmoothLoss(cfg)(dict(zip(HEADS, h)),
                                           {k: jnp.asarray(v) for k, v in batch.items()}),
        argnums=(0, 1, 2, 3)))(*(jnp.asarray(h) for h in heads))
    ts = [torch.from_numpy(h).requires_grad_() for h in heads]
    loss = MultiSmoothLoss(cfg)(dict(zip(HEADS, ts)),
                                {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-5)
    for t, g in zip(ts, grads_j):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-4, atol=1e-6)


# MGE-CNN
MGE_KW = dict(num_classes=5, image_size=64, backbone_name="resnet18")
MGE_KEYS = ("logits", "all_logits", "pr_gate")


def _recording_crop(seen):
    """The JAX module's ``crop_resize_bilinear``, recording its boxes."""
    real = jax_mge.crop_resize_bilinear

    def record(images, boxes, *a, **kw):
        jax.debug.callback(lambda b: seen.append(np.asarray(b)), boxes)
        return real(images, boxes, *a, **kw)

    return record


def _recording_cam_bbox(seen):
    real = mge.cam_bbox

    def record(*a):
        crops, boxes = real(*a)
        seen.append(boxes.numpy())
        return crops, boxes

    return record


@pytest.mark.parametrize("rate", [0.2, 0.6])
def test_cam_bbox_matches_jax(monkeypatch, rate):
    rs = np.random.RandomState(3)
    images = rs.rand(3, 64, 64, 3).astype(np.float32)
    conv5 = np.maximum(rs.randn(3, 2, 2, 8), 0).astype(np.float32)
    conv5[2] = 0.0  # a constant CAM: the whole image
    weights = np.maximum(rs.randn(3, 8), 0).astype(np.float32)
    seen = []
    monkeypatch.setattr(jax_mge, "crop_resize_bilinear", _recording_crop(seen))
    want = jax.jit(lambda i, c, w: jax_mge.cam_bbox(i, c, w, rate, 64))(images, conv5, weights)
    crops, boxes = mge.cam_bbox(torch.from_numpy(images), torch.from_numpy(conv5),
                                torch.from_numpy(weights), rate, 64)
    np.testing.assert_array_equal(boxes.numpy(), seen[0])
    assert boxes[2].tolist() == [0.0, 0.0, 64.0, 64.0]
    assert all(0 < b[2] < 64 or 0 < b[3] < 64 for b in boxes[:2].tolist())
    np.testing.assert_allclose(crops.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())
    assert not crops.requires_grad


def mge_port():
    pm = mge.MGECNN(dtype=torch.float64, **MGE_KW)
    for name in ("expert_0", "expert_1", "expert_2"):
        getattr(pm, name).backbone.to(torch.float64)
    pm.gate_backbone.to(torch.float64)
    return pm


def test_mge_eval_forward_matches_jax(monkeypatch):
    """The eval forward, whose CAMs follow each expert's argmax: ``logits``,
    ``all_logits`` and ``pr_gate`` within 1e-6 of their largest value and
    the two crop boxes of each image identical. The train step, whose CAMs
    follow the labels, is held through both packages' Example trainers in
    test_torch_examples_s3n_mge.py."""
    seen_jax, seen = [], []
    monkeypatch.setattr(jax_mge, "crop_resize_bilinear", _recording_crop(seen_jax))
    monkeypatch.setattr(mge, "cam_bbox", _recording_cam_bbox(seen))
    jm = jax_mge.MGECNN(dtype=jnp.float64, **MGE_KW)
    pm = mge_port()
    variables = port_variables(pm, 9)
    load_jax_variables(pm, variables)
    x = np.random.RandomState(10).rand(2, 64, 64, 3) * 2 - 1
    with jax.enable_x64(True):
        want = jax.device_get(jax.jit(lambda v, xx: jm.apply(v, xx, train=False))(
            variables, jnp.asarray(x)))
    with torch.no_grad():
        got = pm.eval()(torch.from_numpy(x))
    for k in MGE_KEYS:
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0, atol=1e-6 * np.abs(w).max(),
                                   err_msg=k)
    assert got["all_logits"].shape == (10, 2, 5)
    np.testing.assert_array_equal(np.stack(seen), np.stack(seen_jax))
    assert len(seen) == 2 and (seen[0] != seen[1]).any()


def test_fused_experts_is_not_ported():
    with pytest.raises(NotImplementedError, match="fused_experts"):
        mge.build_mge(ConfigNode({"name": "MGE_CNN", "num_classes": 5,
                                  "fused_experts": True}).freeze())


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
def test_mge_loss_matches_jax(weighted):
    rs = np.random.RandomState(4)
    heads = rs.randn(10, 6, 5).astype(np.float32)
    batch = {"label": rs.randint(0, 5, 6)}
    if weighted:
        batch["weight"] = np.array([1, 1, 0, 1, 0, 1], np.float32)
    loss_j, grad_j = jax.jit(jax.value_and_grad(lambda h: JaxMGELoss()(
        {"all_logits": h}, {k: jnp.asarray(v) for k, v in batch.items()})))(
        jnp.asarray(heads))
    h = torch.from_numpy(heads).requires_grad_()
    loss = MGELoss()({"all_logits": h}, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(h.grad.numpy(), np.asarray(grad_j), rtol=1e-4, atol=1e-6)
