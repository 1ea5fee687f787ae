"""The port's device pipeline (hawkeye_tpu_torch/ops/resample.py,
data/ta_wide_device.py, data/transforms_device.py and the datasets'
``decode_size``) against the JAX package on the CPU.

The random streams differ by design, so each test re-derives the JAX
function's own draws with the same ``jax.random.split`` calls and feeds them
to the port's apply functions. Tolerances: float32 resampling atol 1e-5
(products summed in another order); bfloat16 resampling atol 2e-2 (the
intermediate of the two products rounds to bfloat16, a step of 2^-8 near 1,
and the frameworks may round a tie differently); TA-wide ops atol 1e-5 in
float32 (the colour and sharpness sums and the rotation's sine are
evaluated by other libraries)."""

import torch_threads  # noqa: F401  (PyTorch's thread count: see the module)
import functools
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hawkeye_tpu.data import ta_wide_device as jax_ta
from hawkeye_tpu.data import transforms_device as jax_td
from hawkeye_tpu.data.dataset import FGDataset as JaxFGDataset
from hawkeye_tpu.data.dataset import SyntheticDataset as JaxSynthetic
from hawkeye_tpu.ops import resample as jax_rs
from hawkeye_tpu_torch.data import FGDataset, SyntheticDataset
from hawkeye_tpu_torch.data import ta_wide_device as ta
from hawkeye_tpu_torch.data import transforms_device as td
from hawkeye_tpu_torch.ops import resample as rs

HERE = os.path.dirname(os.path.abspath(__file__))


def _t(a):
    return torch.from_numpy(np.array(a))


def _u8(seed, shape):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(np.uint8)


def _boxes(seed, b, h, w):
    rs_ = np.random.RandomState(seed)
    ch = rs_.uniform(4, h, b)
    cw = rs_.uniform(4, w, b)
    return np.stack([rs_.uniform(-2, h - ch + 2), rs_.uniform(-2, w - cw + 2),
                     ch, cw], 1).astype(np.float32)


# ---------------------------------------------------------------------------
# resampling
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("align_corners", [False, True], ids=["half_pixel", "corners"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_crop_resize_bilinear_matches_jax(align_corners, dtype):
    b, h, w = 4, 20, 26
    imgs = np.random.RandomState(0).rand(b, h, w, 3).astype(np.float32)
    boxes = _boxes(1, b, h, w)
    flip = np.array([True, False, True, False])
    want = jax_rs.crop_resize_bilinear(
        jnp.asarray(imgs, dtype), jnp.asarray(boxes), 11, 9,
        align_corners=align_corners, flip_x_mask=jnp.asarray(flip))
    got = rs.crop_resize_bilinear(
        _t(imgs).to(getattr(torch, dtype)), _t(boxes), 11, 9,
        align_corners=align_corners, flip_x_mask=_t(flip))
    assert got.dtype == getattr(torch, dtype) and got.shape == (b, 11, 9, 3)
    atol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)), atol=atol)
    # the folded flip is the flip of the unflipped resample
    plain = rs.crop_resize_bilinear(_t(imgs).to(getattr(torch, dtype)), _t(boxes),
                                    11, 9, align_corners=align_corners)
    torch.testing.assert_close(got, td.hflip(plain, _t(flip)), rtol=0, atol=0)


def test_bilinear_weights_and_resize_match_jax():
    starts = np.array([-3.0, 0.0, 5.5, 17.0], np.float32)
    sizes = np.array([10.0, 24.0, 3.0, 12.0], np.float32)
    for ac in (False, True):  # jitted, as the JAX package runs it
        want = jax.jit(jax_rs._bilinear_weights, static_argnums=(2, 3, 4, 5))(
            jnp.asarray(starts), jnp.asarray(sizes), 24, 7, jnp.float32, ac)
        got = rs._bilinear_weights(_t(starts), _t(sizes), 24, 7, torch.float32,
                                   align_corners=ac)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    u8 = _u8(2, (2, 16, 12, 3))
    want = jax_rs.resize_bilinear(jnp.asarray(u8), 7, 10)
    got = rs.resize_bilinear(_t(u8), 7, 10)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_grid_sample_bilinear_matches_jax_including_outside_samples():
    b, h, w = 3, 9, 11
    imgs = np.random.RandomState(3).rand(b, h, w, 4).astype(np.float32)
    rs_ = np.random.RandomState(4)
    grid = np.stack([rs_.uniform(-3.0, h + 2.0, (b, 6, 7)),
                     rs_.uniform(-3.0, w + 2.0, (b, 6, 7))], -1).astype(np.float32)
    grid[0, 0, :4] = [[-1.0, 2.0], [h - 1.0, 3.0], [-1.5, -1.5], [h, w]]
    want = np.asarray(jax_rs.grid_sample_bilinear(jnp.asarray(imgs),
                                                  jnp.asarray(grid)))
    got = rs.grid_sample_bilinear(_t(imgs), _t(grid)).numpy()
    assert (want == 0).any() and (want != 0).any()  # both regimes are hit
    np.testing.assert_allclose(got, want, atol=1e-5)


# ---------------------------------------------------------------------------
# TrivialAugmentWide
# ---------------------------------------------------------------------------
def _jax_ta_draws(key, b):
    """``ta_wide``'s own draws, by its own splits."""
    k_op, k_mag, k_sign = jax.random.split(key, 3)
    op = jax.random.randint(k_op, (b,), 0, jax_ta.NUM_OPS)
    u = jax.random.uniform(k_mag, (b,))
    sign = jnp.where(jax.random.bernoulli(k_sign, 0.5, (b,)), 1.0, -1.0)
    return np.asarray(op), np.asarray(u * sign)


@functools.lru_cache(maxsize=None)
def _ta_case():
    """A batch whose draws cover all 14 ops, through JAX's ``ta_wide`` and
    the port's apply on JAX's draws."""
    b = 42
    for seed in range(100):
        key = jax.random.PRNGKey(seed)
        op, mag = _jax_ta_draws(key, b)
        if len(set(op.tolist())) == ta.NUM_OPS:
            break
    x = np.random.RandomState(5).rand(b, 24, 20, 3).astype(np.float32)
    x[:, :3] *= 0.3  # a darker band, so the image-level ops have a range
    want = np.asarray(jax.jit(jax_ta.ta_wide)(key, jnp.asarray(x)))
    got = ta.ta_wide_apply(_t(x), _t(op), _t(mag)).numpy()
    return op, x, want, got


@pytest.mark.parametrize("op_index", range(14))
def test_ta_wide_op_matches_jax(op_index):
    op, x, want, got = _ta_case()
    sel = op == op_index
    assert sel.any()
    np.testing.assert_allclose(got[sel], want[sel], atol=1e-5, err_msg=str(op_index))
    if op_index != 0:  # identity is the only op that leaves every image alone
        assert not np.allclose(got[sel], x[sel])


def test_affine_grids_and_equalize_match_jax():
    op = np.arange(ta.NUM_OPS)
    mag = np.linspace(-1.0, 1.0, ta.NUM_OPS).astype(np.float32)
    want = jax_ta._affine_grids(jnp.asarray(op), jnp.asarray(mag), 12, 16)
    got = ta._affine_grids(_t(op), _t(mag), 12, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_array_equal(ta._knots("cpu").numpy(),
                                  np.asarray(jnp.linspace(0.0, 1.0, 64)))
    x = (np.random.RandomState(6).rand(3, 32, 24, 3) ** 3).astype(np.float32)
    knots = np.asarray(jnp.linspace(0.0, 1.0, 64))
    x[0, 0, 0] = 1.0
    x[1, 0, :, 0] = knots[40:]  # pixels exactly on knots
    x[2, 0, :5, 0] = knots[[0, 1, 31, 62, 63]]
    want = np.asarray(jax_ta._equalize_cdf(jnp.asarray(x)))
    got = ta._equalize_cdf(_t(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_sample_ta_wide_covers_the_ops_and_magnitudes():
    g = torch.Generator().manual_seed(0)
    op, mag = ta.sample_ta_wide(g, 4096)
    assert op.dtype == torch.int64 and mag.dtype == torch.float32
    assert set(op.tolist()) == set(range(ta.NUM_OPS))
    assert mag.abs().max() <= 1.0 and (mag < 0).any() and (mag > 0).any()


# ---------------------------------------------------------------------------
# the standard transforms
# ---------------------------------------------------------------------------
def _jax_erase_draws(key, b, prob, scale=(0.02, 0.33), ratio=(0.3, 3.3)):
    k_on, k_area, k_ratio, k_y, k_x = jax.random.split(key, 5)
    return (jax.random.bernoulli(k_on, prob, (b,)),
            jax.random.uniform(k_area, (b,), minval=scale[0], maxval=scale[1]),
            jax.random.uniform(k_ratio, (b,), minval=math.log(ratio[0]),
                               maxval=math.log(ratio[1])),
            jax.random.uniform(k_y, (b,)), jax.random.uniform(k_x, (b,)))


def _jax_rrc_draws(key, b, scale=(0.08, 1.0), ratio=(3 / 4, 4 / 3)):
    k_area, k_ratio, k_y, k_x = jax.random.split(key, 4)
    return (jax.random.uniform(k_area, (b,), minval=scale[0], maxval=scale[1]),
            jax.random.uniform(k_ratio, (b,), minval=math.log(ratio[0]),
                               maxval=math.log(ratio[1])),
            jax.random.uniform(k_y, (b,)), jax.random.uniform(k_x, (b,)))


def test_random_erase_rrc_boxes_flip_and_normalize_match_jax():
    b, h, w = 8, 30, 22
    x = np.random.RandomState(7).randn(b, h, w, 3).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = np.asarray(jax_td.random_erase(key, jnp.asarray(x), prob=0.6))
    draws = [_t(d) for d in _jax_erase_draws(key, b, 0.6)]
    got = td.random_erase(_t(x), *draws).numpy()
    assert (got == 0).any() and (got != 0).any()
    np.testing.assert_array_equal(got, want)

    want = np.asarray(jax_td.sample_rrc_boxes(key, b, h, w))
    got = td.rrc_boxes(*[_t(d) for d in _jax_rrc_draws(key, b)], h, w).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)

    want = np.asarray(jax_td.hflip(key, jnp.asarray(x)))
    mask = np.asarray(jax.random.bernoulli(key, 0.5, (b,)))
    np.testing.assert_array_equal(td.hflip(_t(x), _t(mask)).numpy(), want)

    np.testing.assert_allclose(td.normalize(_t(x)).numpy(),
                               np.asarray(jax_td.normalize(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


def test_samplers_draw_boxes_inside_the_image():
    g = torch.Generator().manual_seed(1)
    boxes = td.sample_rrc_boxes(g, 512, 40, 30)
    y0, x0, ch, cw = boxes.unbind(1)
    assert (y0 >= 0).all() and (x0 >= 0).all()
    assert (y0 + ch <= 40 + 1e-4).all() and (x0 + cw <= 30 + 1e-4).all()
    assert (ch >= 8).all() and (cw >= 8).all()
    on, *_ = td.sample_erase(g, 4096, 0.1)
    assert 0.05 < on.float().mean() < 0.15


def test_eval_transform_matches_jax():
    u8 = _u8(8, (3, 40, 40, 3))
    want = np.asarray(jax_td.make_eval_transform(32)(jnp.asarray(u8)))
    got = td.make_eval_transform(32)(_t(u8))
    assert got.dtype == torch.float32 and got.shape == (3, 32, 32, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def _jax_train_draws(key, b, h, w, erase_prob):
    """``make_train_augment``'s own draws, by its own splits."""
    k_box, k_flip, k_ta, k_erase = jax.random.split(key, 4)
    op, mag = _jax_ta_draws(k_ta, b)
    return {"boxes": _t(jax_td.sample_rrc_boxes(k_box, b, h, w)),
            "flip": _t(jax.random.bernoulli(k_flip, 0.5, (b,))),
            "ta_op": _t(op), "ta_mag": _t(mag),
            "erase": tuple(_t(d) for d in _jax_erase_draws(k_erase, b, erase_prob))}


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_make_train_augment_matches_jax(compute):
    """RRC with the flip, TA-wide, normalize, erase: the whole train
    augmentation on JAX's draws. In bfloat16 TA-wide is left out: its
    posterize and equalize are steps of the rounded crop."""
    b, r, s = 16, 40, 32
    u8 = _u8(9, (b, r, r, 3))
    key = jax.random.PRNGKey(11)
    policy = "ta_wide" if compute == "float32" else None
    aug = jax_td.make_train_augment(s, erase_prob=0.5, auto_augment=policy,
                                    compute_dtype=getattr(jnp, compute))
    want = np.asarray(aug(key, jnp.asarray(u8)))
    draws = _jax_train_draws(key, b, r, r, 0.5)
    if policy is None:
        del draws["ta_op"], draws["ta_mag"]
    got = td.apply_train_augment(_t(u8), draws, s,
                                 compute_dtype=getattr(torch, compute))
    assert got.dtype == torch.float32 and got.shape == (b, s, s, 3)
    got = got.numpy()
    if compute == "bfloat16":
        np.testing.assert_allclose(got, want, atol=1e-1)
        assert np.abs(got - want).mean() < 2e-3
        return
    # normalisation divides by std ~0.22: 1e-5 in [0, 1] is ~5e-5 after it.
    # Equalize counts the pixels at or below each knot: a crop value within
    # rounding of a knot moves the CDF by one pixel, 1/s^2 of the range, for
    # the pixels in the two intervals beside that knot (2/63 of them).
    eq = draws["ta_op"].numpy() == 13
    assert eq.any()
    np.testing.assert_allclose(got[~eq], want[~eq], atol=5e-5)
    step = 1.0 / (s * s) / min(td.IMAGENET_STD)
    np.testing.assert_allclose(got[eq], want[eq], atol=step + 5e-5)
    assert (np.abs(got[eq] - want[eq]) > 5e-5).mean() < 2 / 63


def test_make_train_augment_own_draws():
    u8 = torch.from_numpy(_u8(10, (4, 36, 36, 3)))
    aug = td.make_train_augment(28, auto_augment="ta_wide", out_dtype=torch.bfloat16)
    a = aug(torch.Generator().manual_seed(0), u8)
    b = aug(torch.Generator().manual_seed(0), u8)
    c = aug(torch.Generator().manual_seed(1), u8)
    assert a.shape == (4, 28, 28, 3) and a.dtype == torch.bfloat16
    assert torch.isfinite(a.float()).all()
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)


# ---------------------------------------------------------------------------
# the datasets' decode_size
# ---------------------------------------------------------------------------
def test_decode_size_items_match_jax():
    port = SyntheticDataset(6, 5, 32, decode_size=40)
    ref = JaxSynthetic(6, 5, 32, decode_size=40)
    for i in (0, 5):
        a, b = port[i], ref[i]
        assert a["img"].dtype == np.uint8 and a["img"].shape == (40, 40, 3)
        np.testing.assert_array_equal(a["img"], b["img"])
        assert a["label"] == b["label"]
    # the fixtures are JPEGs: the JAX FGDataset decodes them natively
    # (libjpeg's DCT scaling and one fused resize), and so does the port's
    root = os.path.join(HERE, "fixtures", "images")
    meta = os.path.join(HERE, "fixtures", "meta", "val.txt")
    ds = FGDataset(root, meta, decode_size=48)
    ref = JaxFGDataset(root, meta, decode_size=48)
    for i in (0, len(ds) - 1):
        item = ds[i]
        assert ds.paths[i].endswith(".jpg")
        assert item["img"].shape == (48, 48, 3)
        np.testing.assert_array_equal(item["img"], ref[i]["img"])
