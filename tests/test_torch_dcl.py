"""The port's DCL (hawkeye_tpu_torch/data/dcl.py, models/methods/dcl.py,
losses/dcl.py) against the JAX package's on the CPU.

Data, host: the jigsaw pieces, the four collates and ``DCLCommonAug``
bit-equal on the same ``RandomState`` and Python ``random`` seeds, and
``subsample_per_class``. Data, device: the port's rotation, crop, flip,
jigsaw and 2x batch on the JAX package's own draws (its key split, done
here) within 1e-5 of the largest value, labels and laws exact; the port's
permutation from JAX's uniforms equal to JAX's; the port's own draws give
local permutations; the eval prep. Model and loss at the JAX suite's shape
(tests/test_methods_wave2.py: ResNet-18, 112x112, so c5 is 4x4, the mask
2x2 and the law 4 cells), from the same perturbed weights
(test_torch_osme.perturbed): an eval forward in float32 (logits, swap
logits and mask within 1e-5, the loss rtol 1e-5), one train-mode step
with a float64 trunk (the heads are float32 in both packages) with the
tolerances of test_torch_osme.compare_train_step; the loss alone with and
without weights, both swap-label modes."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import hawkeye_tpu.models  # noqa: F401
from hawkeye_tpu.data import dcl as jdcl
from hawkeye_tpu.losses.dcl import DCLLoss as JaxDCLLoss
from hawkeye_tpu.models.methods.dcl import DCL as JaxDCL
from hawkeye_tpu_torch.data import dcl as pdcl
from hawkeye_tpu_torch.losses.dcl import DCLLoss
from hawkeye_tpu_torch.models import load_jax_variables
from hawkeye_tpu_torch.models.methods.dcl import DCL
from test_torch_osme import compare_train_step, shared_variables, to_f64

CRIT = {"alpha": 1.0, "beta": 0.5, "gamma": 2.0}


def _items(seed, n=3, size=28, weights=False):
    rs = np.random.RandomState(seed)
    items = [{"img": rs.randint(0, 256, (size, size, 3)).astype(np.uint8),
              "label": int(rs.randint(0, 5))} for _ in range(n)]
    if weights:
        items[-1]["weight"] = 0.0
    return items


def _assert_batches_equal(got, want):
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("name,kwargs", [
    ("DCLTrainCollate", {"grid": 7, "cls_2": True, "seed": 3}),
    ("DCLTrainCollate", {"grid": 7, "ran": 1, "cls_2": False, "num_classes": 5,
                         "seed": 4}),
    ("DCLValCollate", {"grid": 7, "cls_2": True}),
    ("DCLValCollate", {"grid": 4, "cls_2": False}),
    ("DCLBackboneCollate", {}),
    ("DCLTestCollate", {}),
])
def test_host_collates_are_bit_equal(name, kwargs):
    port, ref = getattr(pdcl, name)(**kwargs), getattr(jdcl, name)(**kwargs)
    for call in range(2):  # the train collate's generator moves on
        items = _items(call, weights=call == 1)
        _assert_batches_equal(port(items), ref(items))


def test_jigsaw_pieces_and_subsample_are_bit_equal():
    rp, rj = np.random.RandomState(5), np.random.RandomState(5)
    img = np.random.RandomState(6).randint(0, 256, (28, 28, 3)).astype(np.uint8)
    for grid, ran in ((7, 2), (4, 1)):
        perm = pdcl.neighborhood_permutation(rp, grid, ran)
        np.testing.assert_array_equal(perm, jdcl.neighborhood_permutation(rj, grid, ran))
        np.testing.assert_array_equal(pdcl.apply_jigsaw(img, perm, grid),
                                      jdcl.apply_jigsaw(img, perm, grid))
        np.testing.assert_array_equal(pdcl.swap_law(perm, grid), jdcl.swap_law(perm, grid))
        np.testing.assert_array_equal(pdcl.identity_law(grid), jdcl.identity_law(grid))
    labels = np.random.RandomState(7).randint(0, 6, 200)
    np.testing.assert_array_equal(pdcl.subsample_per_class(labels, 0.1, seed=8),
                                  jdcl.subsample_per_class(labels, 0.1, seed=8))


@pytest.mark.parametrize("train", [True, False])
def test_common_aug_is_bit_equal(train):
    arr = np.random.RandomState(9).randint(0, 256, (50, 60, 3)).astype(np.uint8)
    port = pdcl.DCLCommonAug(48, 40, rotate=15, train=train)
    ref = jdcl.DCLCommonAug(48, 40, rotate=15, train=train)
    for seed in range(4):  # rotations, crops and both flips
        random.seed(seed)
        want = ref(Image.fromarray(arr))
        random.seed(seed)
        got = port(Image.fromarray(arr))
        assert got.dtype == np.uint8 and got.shape == (40, 40, 3)
        np.testing.assert_array_equal(got, want)


def _jax_draws(key, b, r, s, rotate, grid, ran):
    """The draws ``make_dcl_device_augment`` makes from ``key``, as the
    port's ``sample_dcl_draws`` returns them."""
    k_rot, k_y, k_x, k_flip, k_perm = jax.random.split(key, 5)
    return {"theta": jax.random.uniform(k_rot, (b,), minval=-rotate, maxval=rotate),
            "top": jax.random.randint(k_y, (b,), 0, r - s + 1),
            "left": jax.random.randint(k_x, (b,), 0, r - s + 1),
            "flip": jax.random.bernoulli(k_flip, 0.5, (b,)),
            "perms": jdcl.device_neighborhood_permutation(k_perm, b, grid, ran)}


@pytest.mark.parametrize("cls_2,weights", [(True, False), (False, True)])
def test_device_augment_on_jax_draws_matches_jax(cls_2, weights):
    b, r, s, grid = 4, 36, 28, 7
    rs = np.random.RandomState(10)
    batch = {"img": rs.randint(0, 256, (b, r, r, 3)).astype(np.uint8),
             "label": np.array([0, 3, 2, 4])}
    if weights:
        batch["weight"] = np.array([1, 1, 0, 1], np.float32)
    key = jax.random.PRNGKey(15)  # flips two of the four
    want = jax.device_get(jdcl.make_dcl_device_augment(
        s, rotate=15.0, grid=grid, ran=2, cls_2=cls_2, num_classes=5)(
            key, {k: jnp.asarray(v) for k, v in batch.items()}))
    draws = {k: torch.from_numpy(np.array(v))
             for k, v in jax.device_get(_jax_draws(key, b, r, s, 15.0, grid, 2)).items()}
    assert draws["flip"].any() and not draws["flip"].all()
    got = pdcl.apply_dcl_augment({k: torch.from_numpy(v) for k, v in batch.items()},
                                 draws, s, grid=grid, cls_2=cls_2, num_classes=5)
    assert got.keys() == want.keys() and got["img"].shape == (2 * b, s, s, 3)
    w = np.asarray(want["img"])
    np.testing.assert_allclose(got["img"].numpy(), w, rtol=1e-5, atol=1e-5 * np.abs(w).max())
    for k in ("label", "label_swap", "swap_law", "weight"):
        if k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_permutations_from_jax_uniforms_match_jax():
    key = jax.random.PRNGKey(12)
    n, grid, ran = 6, 7, 2
    want = jdcl.device_neighborhood_permutation(key, n, grid, ran)
    k1, k2 = jax.random.split(key)
    u1, u2 = (torch.from_numpy(np.array(jax.random.uniform(k, (n, grid, grid))))
              for k in (k1, k2))
    np.testing.assert_array_equal(pdcl.permutations_from_keys(u1, u2, ran).numpy(),
                                  np.asarray(want))


def test_port_draws_give_local_permutations():
    gen = torch.Generator().manual_seed(13)
    draws = pdcl.sample_dcl_draws(gen, 64, 512, 448, grid=7, ran=2)
    perms = draws["perms"].numpy()
    assert (np.sort(perms, axis=1) == np.arange(49)).all()
    pos = np.arange(49)
    # keys index + U(-2, 2): a cell moves at most 3 places in each direction
    assert np.abs(perms // 7 - pos // 7).max() <= 3
    assert np.abs(perms % 7 - pos % 7).max() <= 3
    assert (perms != pos).any(axis=1).all()
    assert draws["theta"].abs().max() <= 15 and draws["top"].max() <= 64
    assert 0 < int(draws["flip"].sum()) < 64


def test_device_eval_matches_jax():
    rs = np.random.RandomState(14)
    batch = {"img": rs.randint(0, 256, (3, 36, 36, 3)).astype(np.uint8),
             "label": np.array([1, 0, 4])}
    for cls_2 in (True, False):
        want = jdcl.make_dcl_device_eval(28, grid=7, cls_2=cls_2)(
            {k: jnp.asarray(v) for k, v in batch.items()})
        got = pdcl.make_dcl_device_eval(28, grid=7, cls_2=cls_2)(
            {k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(got["img"].numpy(), np.asarray(want["img"]),
                                   rtol=1e-6, atol=1e-6)
        for k in ("label_swap", "swap_law"):
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def _dcl_batch(seed, b, cells, cls_2=True, weights=False):
    rs = np.random.RandomState(seed)
    label = rs.randint(0, 4, b)
    batch = {"label": label,
             "label_swap": (rs.randint(0, 2, b) if cls_2 else label + 4 * rs.randint(0, 2, b)),
             "swap_law": rs.uniform(-0.5, 0.5, (b, cells)).astype(np.float32)}
    if weights:
        batch["weight"] = np.array([1, 0] * (b // 2), np.float32)
    return batch


def test_model_eval_forward_and_loss_match_jax():
    x = np.random.RandomState(15).rand(2, 112, 112, 3).astype(np.float32)
    jm = JaxDCL(num_classes=4, cls_2=False, backbone_name="resnet18", dtype=jnp.float32)
    pm = DCL(4, cls_2=False, backbone_name="resnet18", dtype=torch.float32)
    variables = shared_variables(jm, pm, x.shape, 16)
    batch = _dcl_batch(17, 2, 4, cls_2=False)
    out_j = jax.device_get(jax.jit(lambda v, a: jm.apply(v, a, train=False))(variables, x))
    load_jax_variables(pm, variables)
    with torch.no_grad():
        out = pm.eval()(torch.from_numpy(x))
    assert out["swap_logits"].shape == (2, 8) and out["mask"].shape == (2, 4)
    for k in ("logits", "swap_logits", "mask"):
        w = np.asarray(out_j[k])
        np.testing.assert_allclose(out[k].numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max(), err_msg=k)
    want = JaxDCLLoss(CRIT)(out_j, {k: jnp.asarray(v) for k, v in batch.items()})
    got = DCLLoss(CRIT)(out, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


def test_model_train_step_matches_jax_f64_trunk():
    x = np.random.RandomState(18).randn(4, 112, 112, 3)
    jm = JaxDCL(num_classes=4, backbone_name="resnet18", dtype=jnp.float64)
    pm = DCL(4, backbone_name="resnet18", dtype=torch.float64)
    variables = shared_variables(jm, pm, x.shape, 19)
    to_f64(pm.backbone)  # the heads stay float32, as in JAX
    compare_train_step(jm, pm, variables, x, JaxDCLLoss(CRIT), DCLLoss(CRIT),
                       _dcl_batch(20, 4, 4, weights=True),
                       keys=("logits", "swap_logits", "mask"), loss_rtol=1e-5)


@pytest.mark.parametrize("cls_2,weights", [(True, False), (True, True), (False, True)])
def test_loss_matches_jax(cls_2, weights):
    rs = np.random.RandomState(21)
    out = {"logits": rs.randn(6, 4).astype(np.float32) * 2,
           "swap_logits": rs.randn(6, 2 if cls_2 else 8).astype(np.float32),
           "mask": np.tanh(rs.randn(6, 49)).astype(np.float32)}
    batch = _dcl_batch(22, 6, 49, cls_2=cls_2, weights=weights)
    want = JaxDCLLoss(CRIT)({k: jnp.asarray(v) for k, v in out.items()},
                            {k: jnp.asarray(v) for k, v in batch.items()})
    got = DCLLoss(CRIT)({k: torch.from_numpy(v) for k, v in out.items()},
                        {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
