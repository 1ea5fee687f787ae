"""The port's Mixup / CutMix (hawkeye_tpu_torch/data/mixup.py) against the
JAX package's ``mixup_cutmix`` at the JAX function's own draws, reproduced
from its key with ``jax.random.split`` as it makes them (``apply`` and the
branch coins, ``lam`` from its two Gamma draws, the box centre): for keys
that give each branch and no mix, the images and soft labels equal (the
CutMix box edges and area in float32 on both sides, so the masks are the
same). The port's own draws come from a ``torch.Generator``: the same seed
gives the same batch, ``lam`` lies in (0, 1) and the labels sum to 1."""

import torch_threads  # noqa: F401  (PyTorch's thread count: see the module)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hawkeye_tpu.data.mixup import _beta as jax_beta
from hawkeye_tpu.data.mixup import mixup_cutmix as jax_mixup_cutmix
from hawkeye_tpu_torch.data.mixup import mixup_cutmix

MIX_A, CUT_A, P = 0.2, 1.0, 0.5


def jax_draws(key):
    """The draws ``hawkeye_tpu/data/mixup.py`` makes from ``key``."""
    k_apply, k_choice, k_lam, k_box = jax.random.split(key, 4)
    cutmix = bool(jax.random.bernoulli(k_choice, 0.5))
    ky, kx = jax.random.split(k_box)
    return {"apply": bool(jax.random.bernoulli(k_apply, P)), "cutmix": cutmix,
            "lam": float(jax_beta(k_lam, CUT_A if cutmix else MIX_A)),
            "cy": float(jax.random.uniform(ky)), "cx": float(jax.random.uniform(kx))}


def _keys():
    """Seeds whose draws give, in order, CutMix, Mixup and no mix."""
    found = {}
    for seed in range(64):
        d = jax_draws(jax.random.PRNGKey(seed))
        kind = "none" if not d["apply"] else ("cutmix" if d["cutmix"] else "mixup")
        found.setdefault(kind, seed)
    return [found["cutmix"], found["mixup"], found["none"]]


@pytest.mark.parametrize("which", [0, 1, 2], ids=["cutmix", "mixup", "none"])
def test_mixup_cutmix_matches_jax_at_its_draws(which):
    seed = _keys()[which]
    rs = np.random.RandomState(seed)
    images = rs.rand(4, 20, 24, 3).astype(np.float32)
    labels = np.array([0, 3, 1, 4])
    key = jax.random.PRNGKey(seed)
    want_img, want_lab = jax_mixup_cutmix(key, jnp.asarray(images), jnp.asarray(labels), 5,
                                          MIX_A, CUT_A, P)
    img, lab = mixup_cutmix(torch.from_numpy(images), torch.from_numpy(labels), 5,
                            MIX_A, CUT_A, P, draws=jax_draws(key))
    np.testing.assert_array_equal(img.numpy(), np.asarray(want_img))
    np.testing.assert_array_equal(lab.numpy(), np.asarray(want_lab))
    if which == 0:  # a box that is neither empty nor the whole image
        cut = (img.numpy() != images).any(axis=(0, 3))
        assert 0 < cut.sum() < cut.size


def test_generator_draws_are_reproducible_and_valid():
    images = torch.rand(6, 16, 16, 3, generator=torch.Generator().manual_seed(0))
    labels = torch.tensor([0, 1, 2, 3, 4, 0])
    outs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(5)
        outs.append([mixup_cutmix(images, labels, 5, p=1.0, generator=gen)
                     for _ in range(8)])
    kinds = set()
    for (a, la), (b, lb) in zip(*outs):
        assert torch.equal(a, b) and torch.equal(la, lb)
        torch.testing.assert_close(la.sum(-1), torch.ones(6))
        assert ((la > 0) & (la < 1)).any()  # mixed with the rolled batch
        kinds.add(bool(((a == images) | (a == torch.roll(images, 1, 0))).all()))
    assert kinds == {True, False}  # both CutMix and Mixup were drawn
    with pytest.raises(ValueError, match="generator"):
        mixup_cutmix(images, labels, 5)
