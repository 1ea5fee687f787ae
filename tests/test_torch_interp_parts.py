"""The port's Interp-Parts model and loss (hawkeye_tpu_torch/models/methods/
interp_parts.py, losses/interp_parts.py) against the JAX package's on the
CPU.

The model is the JAX class built with ``stage_sizes=(1, 1, 1)`` (as
``tests/test_methods_wave2.py`` builds it), K = 3 parts, at 96x96 (a 6x6
``c4`` map, where the shaping loss's blur is VALID), batch 8: an eval
forward, then one train-mode step through the Interp-Parts loss from the
same weights (see test_torch_osme.py), trunk in float64; the grouping unit
and the 1x1 bottlenecks are float32 in both packages. The weights are
perturbed, every BatchNorm scale included: at init each block's ``bn3``
has scale 0, every post block is the identity, and a wrong conv order
would pass. Tolerances as test_torch_osme.py, but outputs with an atol of
1e-4 of their largest value and the loss rtol 1e-5: the float32 grouping
logits ``2 x.c - |x|^2 - |c|^2`` cancel at |x|^2 ~ 1e3 in both packages,
and the assignments differ by ~5e-5. ``attconv_out``'s bias, right
before a BatchNorm over its one channel, has a gradient of 0 in exact
arithmetic and is held to that instead.

The step is compared where the function is smooth and well-conditioned in
float32, which ``soften`` arranges; at the init's weights it is neither,
in the JAX package alone (its float32 head after a float32 trunk against
after a float64 one: up to 24% of a post block's largest gradient):
- At the init's scale (|x - c|^2 ~ 1e3 at c4) the part assignments are
  one-hot to float32, the blurred maximum is 1 within an ulp, and the
  Beta(1, 0.001) prior is 1 to float32: the shaping loss
  ``|log(emp + eps) - log(prior + eps)|`` sits at its kink, where rounding
  picks the sign of its gradient. ``soften`` scales the last block's
  BatchNorm outputs by 0.05 and draws the centres from N(0, 0.1^2): the
  assignments are soft (largest ~0.9).
- The init's centres are all positive, so every region feature
  ``normalize(mean_x - c)`` shares one direction; the 1x1 convs' channels
  then have a mean far above their spread over the B*K rows, and flax's
  float32 BatchNorm, which takes the variance as E[x^2] - E[x]^2, cancels
  most of its digits there (the port's two-pass variance does not). The
  centres of ``soften`` are symmetric, and the batch is 8 so that the
  statistics run over 24 rows, not 12.
At init the port's ``bn3`` scales are 0 and its part centres at least
1e-5, as flax's.

The loss alone: both padding branches of the blur (VALID at 6x6, SAME at
4x4), no blur (radius 0), values rtol 1e-5 and gradients rtol 1e-4 / atol
1e-6; the Beta prior is built once per batch size and device."""

import torch_threads  # noqa: F401  (PyTorch's thread count: see the module)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hawkeye_tpu.models  # noqa: F401
from hawkeye_tpu.losses.interp_parts import InterpPartsLoss as JaxInterpPartsLoss
from hawkeye_tpu.models.methods.interp_parts import InterpParts as JaxInterpParts
from hawkeye_tpu_torch.losses.interp_parts import InterpPartsLoss
from hawkeye_tpu_torch.models import init_parameters
from hawkeye_tpu_torch.models.methods.interp_parts import InterpParts
from test_torch_osme import compare_eval, compare_train_step, shared_variables

CRIT = {"radius": 2, "std": 0.4, "alpha": 1, "beta": 0.001, "coeff": 0.5}


def soften(variables, seed):
    """Soft part assignments: the last trunk block's BatchNorm outputs
    (``bn3``, ``downsample_bn``) at 0.05x and the centres from
    N(0, 0.1^2)."""
    params = variables["params"]
    *_, last = sorted(k for k in params["backbone"] if k.startswith("layer"))
    for bn in ("bn3", "downsample_bn"):
        for leaf in ("scale", "bias"):
            params["backbone"][last][bn][leaf] = params["backbone"][last][bn][leaf] * 0.05
    k, c = params["grouping"]["weight"].shape
    params["grouping"]["weight"] = (
        np.random.RandomState(seed).randn(k, c) * 0.1).astype(np.float32)
    return variables


def test_interp_parts_train_step_and_eval_match_jax():
    x = np.random.RandomState(15).randn(8, 96, 96, 3)
    jm = JaxInterpParts(num_classes=5, num_parts=3, stage_sizes=(1, 1, 1),
                        dtype=jnp.float64)
    pm = InterpParts(num_classes=5, num_parts=3, stage_sizes=(1, 1, 1),
                     dtype=torch.float64)
    variables = soften(shared_variables(jm, pm, x.shape, 16), 5)
    pm.backbone.to(torch.float64)
    compare_eval(jm, pm, variables, x, out_atol=1e-4)
    out = compare_train_step(jm, pm, variables, x, JaxInterpPartsLoss(CRIT),
                             InterpPartsLoss(CRIT),
                             {"label": np.array([0, 3, 3, 1, 4, 0, 2, 2])},
                             keys=("logits", "att", "assign"),
                             zero_grads=[("attconv_out", "bias")], loss_rtol=1e-5,
                             out_atol=1e-4)
    assert out["assign"].shape == (8, 6, 6, 3) and out["att"].shape == (8, 3)


def test_interp_parts_init_zeroes_bn3_and_clamps_the_centres():
    pm = init_parameters(InterpParts(num_classes=5, num_parts=4, stage_sizes=(1, 1, 1)),
                         torch.Generator().manual_seed(0))
    for name in ("attconv_0", "attconv_1", "post_0", "post_1", "post_2", "post_3"):
        assert not getattr(pm, name).bn3.weight.any(), name
        assert getattr(pm, name).bn2.weight.eq(1).all(), name
    assert pm.grouping.weight.shape == (4, 1024)
    assert pm.grouping.weight.min() >= 1e-5 and pm.grouping.weight.max() > 0.1
    assert not pm.grouping.smooth_factor.any()


@pytest.mark.parametrize("hw,radius", [(6, 2), (4, 2), (5, 0)],
                         ids=["valid_blur", "same_blur", "no_blur"])
def test_interp_parts_loss_matches_jax(hw, radius):
    rs = np.random.RandomState(hw)
    b, k = 6, 3
    assign = rs.randn(b, hw, hw, k).astype(np.float32) * 2
    assign = np.exp(assign) / np.exp(assign).sum(-1, keepdims=True)
    logits = rs.randn(b, 5).astype(np.float32)
    labels = rs.randint(0, 5, b)
    crit = dict(CRIT, radius=radius)

    def jax_loss(a, lg):
        return JaxInterpPartsLoss(crit)({"logits": lg, "assign": a},
                                        {"label": jnp.asarray(labels)})

    loss_j, grads_j = jax.jit(jax.value_and_grad(jax_loss, argnums=(0, 1)))(
        jnp.asarray(assign), jnp.asarray(logits))
    a, lg = (torch.from_numpy(t).requires_grad_() for t in (assign, logits))
    port = InterpPartsLoss(crit)
    loss = port({"logits": lg, "assign": a}, {"label": torch.from_numpy(labels)})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-5)
    for g, w in zip((a.grad, lg.grad), grads_j):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-6)
    prior = port.prior(b, a.device)
    assert port.prior(b, a.device) is prior and prior.shape == (b, 1)
    assert len(port._priors) == 1
