"""The port's NTS-Net model and loss (hawkeye_tpu_torch/models/methods/
ntsnet.py, losses/nts.py) against the JAX package's on the CPU, at
tests/test_ntsnet_fused.py's shapes (a one-block-per-stage trunk, ``TINY``, in
place of its resnet18) at 64x64 with
``pad_side = part_size = 64``, M = 4 proposals, K = 3, batch 3.

Both models take the port's init with every BatchNorm scale and every bias
at random (``port_variables``; the gradient and statistics comparisons
hold the two trees equal, since flax reads only the variables it has and
raises on a missing or misshapen one). The trunk and the
proposal net run in float64 on both sides; the heads are float32 in both
packages (the JAX package's Dense layers and its trunk's ``pool`` are
float32). Eval forwards on the bridged running statistics, then one
train-mode step through ``NTSLoss``, for the sequential path against JAX's
sequential path and the fused path against JAX's fused path: the greedy
picks ``top_idx`` identical, the loss rtol 1e-6, outputs rtol 1e-4 with an
atol of 1e-5 of their largest value, gradients rtol 1e-3 with an atol of
1e-3 of each tensor's largest, running statistics (folded global, then
parts) rtol 1e-5 / atol 1e-5 of the largest (``compare_train_step``).
Dropout is the identity on both sides for these cases (flax's at rate 0,
the port's ``dropout_rate`` set to 0): the two packages draw their masks from
different generators. The port's dropout is checked on its own: two masks
per train forward from the caller's generator, the global features' first,
then the parts', and no draw from the global RNG.

The loss alone: float32 outputs at random with tied part losses (the
ranking's strict ``>``) and a per-sample weight, values rtol 1e-5 and
gradients rtol 1e-4 / atol 1e-6. The anchors and their adjacency: the
port's numpy copies equal to the JAX package's.
"""

import torch_threads  # noqa: F401  (PyTorch's thread count: see the module)
import flax.linen
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import hawkeye_tpu.models  # noqa: F401
from hawkeye_tpu.losses.nts import NTSLoss as JaxNTSLoss
from hawkeye_tpu.models.methods import ntsnet as jax_ntsnet
from hawkeye_tpu.ops.nms import nms_fixed_anchors_batch as jax_nms_batch
from hawkeye_tpu_torch.losses.nts import NTSLoss
from hawkeye_tpu_torch.models.methods import ntsnet
from hawkeye_tpu_torch.models.methods.ntsnet import NTSNet
from hawkeye_tpu_torch.models import export_jax_variables, init_parameters, load_jax_variables
from test_torch_osme import perturbed
from test_torch_region_ops import stats64
from test_torch_resnet import TINY, _assert_close_scaled, _leaves, _port_grads
from test_torch_resnet import tiny_trunk  # noqa: F401  (a fixture: pytestmark)

pytestmark = pytest.mark.usefixtures("tiny_trunk")

KW = dict(num_classes=5, proposal_num=4, cat_num=3, image_size=64, pad_side=64,
          part_size=64, backbone_name=TINY)
KEYS = ("logits", "raw_logits", "part_logits", "top_prob")
TOL = 1e-5  # float32 heads: the outputs and gradients agree to a few 1e-7


class _NoDropout:
    """``flax.linen`` whose ``Dropout`` has rate 0, for the JAX NTS-Net."""

    def __getattr__(self, name):
        return getattr(flax.linen, name)

    @staticmethod
    def Dropout(rate):  # noqa: N802
        return flax.linen.Dropout(0.0)


JAX_PICKS = []  # the JAX models' greedy picks, one [B, M] array per forward


def _recording_nms(scores, adjacency, topn):
    idx, vals = jax_nms_batch(scores, adjacency, topn)
    jax.debug.callback(lambda i: JAX_PICKS.append(np.asarray(i)), idx)
    return idx, vals


@pytest.fixture(scope="module")
def nts():
    """The JAX models (sequential, fused), with their dropout the identity
    and their picks recorded, the shared variables, the input and the
    labels."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_ntsnet, "nn", _NoDropout())
        mp.setattr(jax_ntsnet, "nms_fixed_anchors_batch", _recording_nms)
        jms = {fused: jax_ntsnet.NTSNet(dtype=jnp.float64, fused_part_pass=fused, **KW)
               for fused in (False, True)}
        x = np.random.RandomState(0).rand(2, 64, 64, 3)
        variables = port_variables(port(False), 3)
        yield jms, variables, x, {"label": np.array([0, 3])}


def port_variables(pm, seed):
    """The port's init of ``pm``, perturbed, in the flax layout."""
    init_parameters(pm, torch.Generator().manual_seed(seed))
    return perturbed(export_jax_variables(pm), seed)


def port(fused):
    pm = NTSNet(dtype=torch.float64, fused_part_pass=fused, **KW)
    pm.dropout_rate = 0.0
    pm.backbone.to(torch.float64)
    pm.proposal_net.to(torch.float64)
    return pm


def recorded_picks(pm):
    """Records each ``_nms`` result of ``pm``."""
    seen = []
    real = pm._nms

    def record(scores):
        seen.append(real(scores))
        return seen[-1]

    pm._nms = record
    return seen


def jax_eval_and_train_step(jm, variables, x, criterion, batch, rngs=None,
                            with_eval=True):
    """One compiled program: the eval-mode outputs on the running statistics
    (None without ``with_eval``) and one train-mode forward and backward of
    ``jm`` through ``criterion`` in float64, as numpy: (eval outputs, loss,
    outputs, gradients, new batch statistics)."""
    with jax.enable_x64(True):
        xx = jnp.asarray(x, jnp.float64)
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

        def loss_fn(p):
            out, mut = jm.apply({"params": p, "batch_stats": variables["batch_stats"]},
                                xx, train=True, mutable=["batch_stats"], rngs=rngs)
            return criterion(out, jbatch), (out, mut["batch_stats"])

        def both(v):
            (loss, (out, stats)), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                v["params"])
            ev = jm.apply(v, xx, train=False) if with_eval else None
            return ev, loss, out, grads, stats

        return jax.device_get(jax.jit(both)(variables))


def assert_step_matches(pm, variables, x, want, port_crit, batch, keys, tol,
                        grad_tol=None, zero_grads=(), stats_tol=1e-6, **port_kw):
    """The port's eval forward and train step (``port_kw`` to its train
    forward) from ``variables`` against ``jax_eval_and_train_step``'s
    ``want``: the loss rtol 1e-6, outputs within ``tol`` and gradients
    within ``grad_tol`` (default ``tol``) of each tensor's largest value,
    the running statistics within ``stats_tol``. Gradients whose flax path ends with
    one of ``zero_grads`` are 0 in exact arithmetic (a bias before a
    train-mode BatchNorm): both below 1e-6 of the model's largest gradient,
    and not compared. Returns the port's (eval, train) outputs."""
    eval_j, loss_j, out_j, grads_j, stats_j = want
    load_jax_variables(pm, variables)
    with torch.no_grad():
        ev = pm.eval()(torch.from_numpy(x))
    out = pm.train()(torch.from_numpy(x), **port_kw)
    loss = port_crit(out, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-6)
    for got, ref in ((ev, eval_j), (out, out_j)):
        for k in keys if ref is not None else ():
            w = np.asarray(ref[k])
            np.testing.assert_allclose(got[k].detach().numpy(), w, rtol=0,
                                       atol=tol * np.abs(w).max(), err_msg=k)
    got, ref = _leaves(_port_grads(pm)), _leaves(grads_j)
    assert got.keys() == ref.keys()
    top = max(np.abs(v).max() for v in ref.values())
    for k, w in ref.items():
        if k.endswith(zero_grads):
            assert max(np.abs(w).max(), np.abs(got[k]).max()) <= 1e-6 * top, k
            continue
        np.testing.assert_allclose(got[k], w, rtol=0, err_msg=k,
                                   atol=(grad_tol or tol) * np.abs(w).max())
    _assert_close_scaled(stats64(pm), stats_j, rtol=0, scale_tol=stats_tol)
    return ev, out


@pytest.mark.parametrize("fused", [False, True], ids=["sequential", "fused"])
def test_ntsnet_train_step_and_eval_match_jax(nts, fused):
    """The fused path's eval forward is held against the port's sequential
    one, which the sequential case holds against JAX's."""
    jms, variables, x, batch = nts
    pm = port(fused)
    picks = recorded_picks(pm)
    JAX_PICKS.clear()
    want = jax_eval_and_train_step(jms[fused], variables, x, JaxNTSLoss(), batch,
                                   with_eval=not fused)
    ev, out = assert_step_matches(pm, variables, x, want, NTSLoss(), batch, KEYS, TOL)
    assert out["part_logits"].shape == (2, 4, 5)
    if fused:
        seq = port(False)
        load_jax_variables(seq, variables)
        with torch.no_grad():
            ev_seq = seq.eval()(torch.from_numpy(x))
        for k in KEYS:
            torch.testing.assert_close(ev[k], ev_seq[k], rtol=0, atol=1e-12)
        picks = picks[1:]  # the train forward's; the eval's are the sequential's
    # (the JAX program's callbacks come in either order)
    assert sorted(p.numpy().tolist() for p in picks) == sorted(
        p.tolist() for p in JAX_PICKS)
    assert len({tuple(r) for r in picks[-1].tolist()}) > 1  # rows pick differently


def test_ntsnet_dropout_draws_from_the_callers_generator(monkeypatch):
    masks = []
    real = ntsnet.dropout

    def record(t, rate, generator):
        out = real(t, rate, generator)
        masks.append((tuple(t.shape), rate))
        return out

    monkeypatch.setattr(ntsnet, "dropout", record)
    pm = NTSNet(dtype=torch.float32, **dict(KW, image_size=32, pad_side=32,
                                            part_size=32)).train()
    x = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    with pytest.raises(ValueError, match="generator"):
        pm(x)
    masks.clear()
    state = torch.random.get_rng_state()
    a = pm(x, generator=torch.Generator().manual_seed(7))
    assert masks == [((2, 512), 0.5), ((8, 512), 0.5)]  # global, then parts
    assert torch.equal(torch.random.get_rng_state(), state)
    b = pm(x, generator=torch.Generator().manual_seed(7))
    torch.testing.assert_close(a["logits"], b["logits"], rtol=0, atol=0)
    masks.clear()
    with torch.no_grad():
        pm.eval()(x)
    assert masks == []


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "weighted"])
def test_nts_loss_matches_jax(weighted):
    rs = np.random.RandomState(5)
    b, m, c = 4, 5, 6
    raw, cat = (rs.randn(b, c).astype(np.float32) for _ in range(2))
    part = rs.randn(b, m, c).astype(np.float32)
    part[:, 3] = part[:, 1]  # tied part losses: the strict > skips the pair
    prob = rs.randn(b, m).astype(np.float32)
    labels = rs.randint(0, c, b)
    batch = {"label": labels}
    if weighted:
        batch["weight"] = np.array([1, 0, 1, 1], np.float32)

    def outputs(r, ct, p, s):
        return {"raw_logits": r, "logits": ct, "part_logits": p, "top_prob": s}

    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda *a: JaxNTSLoss()(outputs(*a), {k: jnp.asarray(v) for k, v in batch.items()}),
        argnums=(0, 1, 2, 3)))(*(jnp.asarray(t) for t in (raw, cat, part, prob)))
    ts = [torch.from_numpy(t).requires_grad_() for t in (raw, cat, part, prob)]
    loss = NTSLoss()(outputs(*ts), {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), rtol=1e-5)
    for t, g in zip(ts, grads_j):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("size", [64, 224, 448])
def test_anchors_and_adjacency_match_jax(size):
    np.testing.assert_array_equal(ntsnet.generate_anchors(size),
                                  jax_ntsnet.generate_anchors(size))
    pm = NTSNet(num_classes=5, image_size=size, backbone_name="resnet18")
    edge = np.trunc(jax_ntsnet.generate_anchors(size) + 224).astype(np.float32)
    np.testing.assert_array_equal(pm.edge_anchors.numpy(), edge)
    np.testing.assert_array_equal(
        pm.adjacency.numpy(), jax_ntsnet.anchor_adjacency(edge, 0.25))
    assert "edge_anchors" not in pm.state_dict()  # constants, not weights
