"""The cross-replica BatchNorm (``models/backbones/norm.py``
``_GlobalBatchNorm`` on ``ops/batch_norm.py``) on the CPU, where its four
passes run their plain versions:

* in float64, in a world of two whose all-reduce is the identity, a
  ``BatchNorm`` layer matches autograd through the composite it replaced
  (``composite`` below: float32-or-wider sums, flax's fast variance): y,
  the folded running statistics, dx, dweight and dbias, on channels-last
  NCHW maps, on 2-D rows, on one channel and on a ``[B, C, 1, 1]`` view;
  the Function passes ``gradcheck``;
* the wrappers take a contiguous 2-D tensor or a channels-last NCHW map
  (a view, no copy) and refuse any other layout;
* every model site that reaches the path hands it a channels-last map or
  2-D rows, and its gradient arrives in the same layout (no copy): the
  ResNet's ``BatchNorm`` and ``GroupedBatchNorm`` (batch slices), the
  stacked trunks of the fused passes, the VGG-BN trunk, a 2-D head and
  Interp-Parts' region map;
* two gloo processes (``torch_bn_xr_worker.py``), each with half a batch,
  match one process on the whole batch: y and dx (each rank's rows), the
  statistics, and the rank-summed dweight and dbias.
"""

import torch_threads  # noqa: F401  (PyTorch's thread count: see the module)
import os
import socket
import subprocess
import sys

import pytest
import torch

import hawkeye_tpu_torch.models  # noqa: F401  (registry side effects)
from hawkeye_tpu_torch import BACKBONE
from hawkeye_tpu_torch.models.backbones import norm
from hawkeye_tpu_torch.models.backbones.resnet import stacked_forward
from hawkeye_tpu_torch.models.methods.interp_parts import Bottleneck1x1
from hawkeye_tpu_torch.ops import batch_norm as bn
from torch_bn_xr_worker import CASES, case_tensors

HERE = os.path.dirname(os.path.abspath(__file__))
EPS = 1e-5
TOL = 1e-12


def composite(x, weight, bias, eps):
    """The former cross-replica path in one process (its all-reduce of
    ``[sum, sum of squares, count]`` the identity), differentiable."""
    c = x.shape[1]
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    dims = [d for d in range(x.dim()) if d != 1]
    count = torch.full((1,), x.numel() // c, dtype=xf.dtype)
    stats = torch.cat([xf.sum(dims), (xf * xf).sum(dims), count])
    mean = stats[:c] / stats[-1]
    var = torch.clamp_min(stats[c:2 * c] / stats[-1] - mean * mean, 0.0)
    invstd = torch.rsqrt(var + eps)
    shape = (1, -1) + (1,) * (x.dim() - 2)
    y = ((x.to(mean.dtype) - mean.view(shape)) * (invstd * weight).view(shape)
         + bias.view(shape)).to(x.dtype)
    return y, mean.detach(), var.detach()


@pytest.fixture
def world_of_two(monkeypatch):
    """A world of two processes whose all-reduce is the identity: the
    cross-replica path on one process's batch."""
    monkeypatch.setattr(norm, "world", lambda: (0, 2))
    monkeypatch.setattr(norm, "all_reduce_sum", lambda t: t)


def _rel(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-300))


def _input(kind, gen):
    shapes = {"nchw": (4, 6, 5, 3), "rows": (7, 5), "one_channel": (3, 1, 4, 4)}
    if kind == "pooled":  # [B, C] viewed as [B, C, 1, 1], as Interp-Parts' groupingbn
        return torch.randn((5, 6), generator=gen, dtype=torch.float64)[:, :, None, None]
    x = torch.randn(shapes[kind], generator=gen, dtype=torch.float64) * 2 + 0.5
    return x.contiguous(memory_format=torch.channels_last) if x.dim() == 4 else x


@pytest.mark.parametrize("kind", ["nchw", "rows", "one_channel", "pooled"])
def test_function_matches_the_composite_in_float64(world_of_two, kind):
    gen = torch.Generator().manual_seed(3)
    x = _input(kind, gen)
    c = x.shape[1]
    dy = torch.randn(x.shape, generator=gen, dtype=torch.float64)
    layer = norm.BatchNorm(c, cross_replica=True).double()
    with torch.no_grad():
        layer.weight.copy_(torch.rand(c, generator=gen, dtype=torch.float64) + 0.5)
        layer.bias.copy_(torch.randn(c, generator=gen, dtype=torch.float64))
    weight = layer.weight.detach().clone().requires_grad_(True)
    bias = layer.bias.detach().clone().requires_grad_(True)
    xa, xb = (x.detach().clone().requires_grad_(True) for _ in range(2))

    y = layer(xa)
    (y * dy).sum().backward()
    y_ref, mean, var = composite(xb, weight, bias, EPS)
    (y_ref * dy).sum().backward()
    assert _rel(y.detach(), y_ref.detach()) <= TOL
    assert _rel(xa.grad, xb.grad) <= TOL
    assert _rel(layer.weight.grad, weight.grad) <= TOL
    assert _rel(layer.bias.grad, bias.grad) <= TOL
    assert _rel(layer.running_mean, 0.1 * mean) <= TOL
    assert _rel(layer.running_var, 0.9 + 0.1 * var) <= TOL
    if x.dim() == 4:
        assert y.is_contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("kind", ["nchw", "rows"])
def test_function_passes_gradcheck(kind):
    gen = torch.Generator().manual_seed(4)
    x = _input(kind, gen).requires_grad_(True)
    c = x.shape[1]
    w = (torch.rand(c, generator=gen, dtype=torch.float64) + 0.5).requires_grad_(True)
    b = torch.randn(c, generator=gen, dtype=torch.float64, requires_grad=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(norm, "all_reduce_sum", lambda t: t)
        assert torch.autograd.gradcheck(
            lambda x, w, b: norm._GlobalBatchNorm.apply(x, w, b, EPS)[0], (x, w, b))


def test_wrappers_take_rows_and_channels_last_maps_only():
    x = torch.randn((2, 8, 4, 4))
    cl = x.contiguous(memory_format=torch.channels_last)
    assert bn.rows(cl).data_ptr() == cl.data_ptr() and bn.rows(cl).shape == (32, 8)
    rows2 = torch.randn((6, 8))
    assert bn.rows(rows2) is rows2
    for bad in (x, x[:, :, :, :2].contiguous(memory_format=torch.channels_last)[..., :1],
                torch.randn((2, 8, 4)), rows2.t()):
        with pytest.raises(ValueError, match="channels-last"):
            bn.batch_norm_stats(bad)
    with pytest.raises(ValueError, match="channels-last"):
        bn.batch_norm_backward_reduce(x, cl, torch.zeros(8), torch.ones(8))


def _resnet(**kw):
    m = BACKBONE.get("resnet18")(num_classes=3, dtype=torch.float32, **kw)
    return m.train()


def _site(name, gen):
    """(the site's modules, a callable on its input, the input)."""
    if name == "resnet18":
        m = _resnet()
        return [m], lambda x: m(x)["logits"], torch.randn((4, 32, 32, 3), generator=gen)
    if name == "resnet18_grouped":
        m = _resnet(grouped_bn=True)
        return [m], lambda x: m(x, bn_groups=(2, 4))["logits"], torch.randn(
            (6, 32, 32, 3), generator=gen)
    if name == "stacked_trunks":  # the fused passes' trunks as one grouped pass
        trunks = [_resnet() for _ in range(2)]
        return trunks, lambda x: stacked_forward(trunks, x)["c5"], torch.randn(
            (2, 32, 32, 6), generator=gen)
    if name == "vgg11_bn":
        m = BACKBONE.get("vgg11_bn")(dtype=torch.float32).train()
        return [m], lambda x: m(x)["pool"], torch.randn((2, 32, 32, 3), generator=gen)
    if name == "rows_2d":  # the heads' BatchNorm over [B, C] (AP-CNN)
        m = norm.BatchNorm(6)
        return [m], m, torch.randn((5, 6), generator=gen)
    m = Bottleneck1x1(16, 4)  # Interp-Parts: the [B, C, K, 1] region map
    return [m], lambda r: m(r.transpose(1, 2)[..., None]), torch.randn(
        (2, 5, 16), generator=gen)


@pytest.mark.parametrize("name", ["resnet18", "resnet18_grouped", "stacked_trunks",
                                  "vgg11_bn", "rows_2d", "interp_parts_region"])
def test_model_sites_hand_the_path_their_layout(world_of_two, monkeypatch, name):
    """Each site's train forward and backward through the cross-replica
    path: no layout refused, and every norm call's gradient arriving in its
    input's layout (the backward copies nothing)."""
    modules, fn, x = _site(name, torch.Generator().manual_seed(5))
    for m in modules:
        norm.set_cross_replica(m, True)
    arrived, backward = [], norm._GlobalBatchNorm.backward

    def recording(ctx, dy, *rest):
        fmt = torch.channels_last if dy.dim() == 4 else torch.contiguous_format
        arrived.append(dy.is_contiguous(memory_format=fmt))
        return backward(ctx, dy, *rest)

    monkeypatch.setattr(norm._GlobalBatchNorm, "backward", staticmethod(recording))
    fn(x).float().square().sum().backward()
    n_layers = sum(isinstance(b, norm.BatchNorm) for m in modules for b in m.modules())
    calls = {"resnet18_grouped": 2 * n_layers, "stacked_trunks": n_layers // 2}
    assert len(arrived) == calls.get(name, n_layers) and all(arrived), arrived


def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("bn_xr")
    port, world = _free_port(), 2
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(HERE), os.environ.get("PYTHONPATH", "")]))
    env.pop("PYTEST_XDIST_WORKER", None)
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "torch_bn_xr_worker.py"),
                               str(r), str(world), str(port), str(out)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)[-4000:]
    return [torch.load(out / f"rank{r}.pt") for r in range(world)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_two_ranks_match_one_process_on_the_whole_batch(two_ranks, case):
    shape, channels_last, seed = CASES[case]
    x, dy, weight, bias = case_tensors(shape, channels_last, seed)
    x = x.detach().requires_grad_(True)
    w, b = (t.detach().clone().requires_grad_(True) for t in (weight, bias))
    y, mean, var = composite(x, w, b, EPS)
    (y * dy).sum().backward()
    per = shape[0] // 2
    for r, got in enumerate(g[case] for g in two_ranks):
        rows = slice(r * per, (r + 1) * per)
        assert _rel(got["y"], y.detach()[rows]) <= TOL
        assert _rel(got["dx"], x.grad[rows]) <= TOL
        assert _rel(got["running_mean"], 0.1 * mean) <= TOL
        assert _rel(got["running_var"], 0.9 + 0.1 * var) <= TOL
    for key, want in (("dweight", w.grad), ("dbias", b.grad)):
        assert _rel(two_ranks[0][case][key] + two_ranks[1][case][key], want) <= TOL
