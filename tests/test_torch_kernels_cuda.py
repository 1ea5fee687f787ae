"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and nvcc and skips without them;
the file imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py

Pool values, codes and gradients must be bit-exact; the Gram within
rtol 1e-4 / atol 1e-5 of the plain float32 product (accumulation order and
the bf16 kernel's approximate square root); the cross-replica BatchNorm's
sums within 1e-5 of each channel's sum of magnitudes (float32 sums in
another order), its y and dx within one bf16 ulp of the plain version
given the same statistics (float32: 1e-6 of the largest value)."""

import torch_threads  # noqa: F401  (PyTorch's thread count: see the module)
import pytest
import torch

from hawkeye_tpu_torch.ops import _build
from hawkeye_tpu_torch.ops import batch_norm as bn
from hawkeye_tpu_torch.ops import fused_bilinear, pool

pytestmark = pytest.mark.cuda
BN_KERNELS = ("batch_norm_stats", "batch_norm_apply", "batch_norm_backward_reduce",
              "batch_norm_backward_apply")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    return gen


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 16, 12, 72), (3, 6, 10, 5),
                                   (2, 448, 448, 64), (16, 224, 224, 64),
                                   (16, 112, 112, 128), (16, 56, 56, 256),
                                   (16, 28, 28, 512), (16, 14, 14, 512),
                                   (16, 448, 448, 64), (16, 224, 224, 128),
                                   (16, 112, 112, 256), (16, 56, 56, 512)],
                         ids=["vector", "scalar", "vgg_block1", "vgg224_b16_1",
                              "vgg224_b16_2", "vgg224_b16_3", "vgg224_b16_4",
                              "vgg224_b16_5", "vgg448_b16_1", "vgg448_b16_2",
                              "vgg448_b16_3", "vgg448_b16_4"])
def test_pool_kernels_bit_exact(card, dtype, shape):
    """The shapes: vector and scalar paths, VGG-16's first map at 448x448,
    its five pool inputs at 224x224, batch 16 (Peer-Learning, CBCNN stage
    1), and at 448x448, batch 16 (CBCNN stage 2; its fifth,
    ``(16, 28, 28, 512)``, is the 224x224 path's fourth)."""
    x = (torch.round(torch.randn(shape, device="cuda", generator=card) * 2) / 2
         ).to(dtype)
    _build.reset_launches()
    p, idx = pool.pool_fwd(x)
    p_ref, idx_ref = pool.pool_fwd_plain(x)
    assert torch.equal(p, p_ref) and torch.equal(idx, idx_ref)
    dp = torch.randn(p.shape, device="cuda", generator=card).to(dtype)
    assert torch.equal(pool.pool_bwd(dp, idx, p), pool.pool_bwd_plain(dp, idx, p))
    assert _build.LAUNCHES["pool_fwd"] == 1 and _build.LAUNCHES["pool_bwd"] == 1


def test_pool_autograd_on_card(card):
    x = torch.randn((2, 8, 8, 16), device="cuda", generator=card,
                    requires_grad=True)
    p = pool.relu_maxpool2x2(x)
    p.backward(torch.ones_like(p))
    ref = torch.nn.functional.max_pool2d(torch.relu(x.permute(0, 3, 1, 2)), 2)
    assert torch.equal(p, ref.permute(0, 2, 3, 1))
    xr = x.detach().clone().requires_grad_(True)
    torch.nn.functional.max_pool2d(torch.relu(xr.permute(0, 3, 1, 2)), 2).sum(
        ).backward()
    assert torch.equal(x.grad, xr.grad)


def test_pool_wrappers_reject_what_the_kernel_does_not_take(card):
    x = torch.randn((2, 8, 8, 16), device="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        pool.pool_fwd(x.permute(0, 2, 1, 3))
    with pytest.raises(TypeError):
        pool.pool_fwd(x.half())
    with pytest.raises(ValueError, match="even"):
        pool.pool_fwd(x[:, :7].contiguous())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 50, 200), (8, 196, 512), (1, 4, 64),
                                   (128, 196, 512), (2, 784, 512),
                                   (2, 196, 2048), (16, 49, 512)],
                         ids=["ragged", "bcnn", "one_tile", "bcnn_b128",
                              "map28", "resnet50_width", "peer_learning_224"])
def test_gram_kernel_close_to_plain(card, dtype, shape):
    """Both kernels (bf16 wgmma, float32 FMA) against the plain float32
    product of the same inputs: rtol 1e-4 / atol 1e-5, for accumulation
    order (bf16 products are exact in float32) and, in the bf16 kernel's
    epilogue, the multiply by 1/HW and the hardware square root (relative
    error below 2^-22, far inside the tolerance). The shapes: the main
    path at batch 8 and 128, ragged HW and C, one tile, the 28x28 map (HW
    spans many ring stages), the ResNet-50 width and Peer-Learning's 7x7
    map at batch 16 (HW = 49, no multiple of the k16 step: the last step
    reads TMA's zero fill)."""
    x = torch.relu(torch.randn(shape, device="cuda", generator=card)).to(dtype)
    _build.reset_launches()
    got = fused_bilinear.gram_signed_sqrt_forward(x)
    want = fused_bilinear.gram_signed_sqrt_plain(x)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
    assert _build.LAUNCHES["gram_signed_sqrt"] == 1


def test_gram_bf16_rejects_a_row_pitch_tma_cannot_take(card):
    x = torch.rand((2, 9, 100), device="cuda", generator=card).to(torch.bfloat16)
    _build.reset_launches()
    with pytest.raises(ValueError, match="row pitch"):
        fused_bilinear.gram_signed_sqrt_forward(x)
    assert _build.LAUNCHES["gram_signed_sqrt"] == 0


def test_gram_autograd_on_card(card):
    x = torch.rand((2, 9, 256), device="cuda", generator=card,
                   requires_grad=True)
    xr = x.detach().clone().requires_grad_(True)
    (fused_bilinear.bilinear_pool_fused(x.view(2, 3, 3, 256)) ** 2).sum().backward()
    from hawkeye_tpu_torch.ops.bilinear import bilinear_pool

    (bilinear_pool(xr.view(2, 3, 3, 256)) ** 2).sum().backward()
    torch.testing.assert_close(x.grad, xr.grad, rtol=1e-4, atol=1e-6)


def _bf16_ulps(got, want):
    """The largest distance in units of the bf16 spacing at the larger
    magnitude of the two."""
    a, b = got.float(), want.float()
    _, e = torch.frexp(torch.maximum(a.abs(), b.abs()))
    return float(((a - b).abs() / torch.ldexp(torch.ones_like(a), e - 8)).max())


def _rel(got, want):
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(64, 64, 224, 224), (64, 2048, 14, 14), (3, 5, 7, 9),
                                   (37, 200)],
                         ids=["dp4_stem", "dp4_layer4", "scalar", "rows_2d"])
def test_batch_norm_kernels_close_to_plain(card, dtype, shape):
    """The four kernels against their plain versions on the card, each
    given the same inputs: the dp4 cell's largest and smallest norm inputs
    (ResNet-50 at 448x448, 64 a rank), a width no 16-byte vector divides
    (one channel a thread) and a 2-D input. One launch a call."""
    x = (torch.randn(shape, device="cuda", generator=card) * 2 + 0.5).to(dtype)
    dy = torch.randn(shape, device="cuda", generator=card).to(dtype)
    if len(shape) == 4:
        x, dy = (t.contiguous(memory_format=torch.channels_last) for t in (x, dy))
    c = shape[1]
    w = torch.rand(c, device="cuda", generator=card) + 0.5
    b = torch.randn(c, device="cuda", generator=card)
    rx, rdy = bn.rows(x), bn.rows(dy)
    xd, dyd = rx.double(), rdy.double()
    _build.reset_launches()

    stats = bn.batch_norm_stats(x)
    mag = torch.cat([xd.abs().sum(0), (xd * xd).sum(0), torch.ones(1, device="cuda")])
    assert float(((stats - bn.batch_norm_stats_plain(rx)).double().abs() / mag).max()) <= 1e-5
    assert float(stats[-1]) == rx.shape[0]
    y, mean, var, invstd = bn.batch_norm_apply(x, stats, w, b, 1e-5)
    want = bn.batch_norm_apply_plain(rx, stats, w, b, 1e-5)
    for got, ref in zip((mean, var, invstd), want[1:]):
        torch.testing.assert_close(got, ref, rtol=1e-6, atol=0)
    assert y.shape == x.shape and y.stride() == x.stride()
    sums, dweight, dbias = bn.batch_norm_backward_reduce(dy, x, mean, invstd)
    mag = torch.cat([dyd.abs().sum(0), (dyd * (xd - mean.double())).abs().sum(0)
                     * invstd.double()])
    sums_p = bn.batch_norm_backward_reduce_plain(rdy, rx, mean, invstd)[0]
    assert float(((sums - sums_p).double().abs() / mag).max()) <= 1e-5
    assert torch.equal(dbias, sums[:c]) and torch.equal(dweight, sums[c:])
    dx = bn.batch_norm_backward_apply(dy, x, mean, invstd, w, sums, stats[-1:])
    dx_p = bn.batch_norm_backward_apply_plain(rdy, rx, mean, invstd, w, sums, stats[-1:])
    assert dx.shape == x.shape and dx.stride() == x.stride()
    if dtype == torch.bfloat16:
        assert _bf16_ulps(bn.rows(y), want[0]) <= 1 and _bf16_ulps(bn.rows(dx), dx_p) <= 1
    else:
        assert _rel(bn.rows(y), want[0]) <= 1e-6 and _rel(bn.rows(dx), dx_p) <= 1e-6
    torch.cuda.synchronize()
    assert {k: _build.LAUNCHES[k] for k in BN_KERNELS} == dict.fromkeys(BN_KERNELS, 1)


def test_batch_norm_wrappers_reject_what_the_kernels_do_not_take(card):
    x = torch.randn((2, 8, 4, 4), device="cuda", generator=card)  # NCHW-contiguous
    with pytest.raises(ValueError, match="channels-last"):
        bn.batch_norm_stats(x)
    with pytest.raises(TypeError):
        bn.batch_norm_stats(x.double().contiguous(memory_format=torch.channels_last))
    with pytest.raises(TypeError):
        bn.batch_norm_stats(x.half().contiguous(memory_format=torch.channels_last))
    cl = x.contiguous(memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="channels-last"):
        bn.batch_norm_backward_reduce(x, cl, torch.zeros(8, device="cuda"),
                                      torch.ones(8, device="cuda"))
    _build.reset_launches()
    stats = bn.batch_norm_stats(cl)
    with pytest.raises(TypeError, match="float32"):
        bn.batch_norm_apply(cl, stats, torch.ones(8, device="cuda").double(),
                            torch.zeros(8, device="cuda"), 1e-5)
    assert _build.LAUNCHES["batch_norm_apply"] == 0


def test_global_batch_norm_in_a_resnet_on_card(card, monkeypatch):
    """A float32 ResNet-18 train step (64x64, batch 4, TF32 off) with
    cross-replica BatchNorm in a world of two whose all-reduce is the
    identity: every norm layer runs the four kernels once, its gradient
    arrives channels-last (no copy), and the logits and every gradient are
    the native path's within 1e-4 of the largest value (float32 sums in
    another order)."""
    import hawkeye_tpu_torch.models  # noqa: F401  (registry side effects)
    from hawkeye_tpu_torch import BACKBONE
    from hawkeye_tpu_torch.models.backbones import norm

    torch.manual_seed(0)
    model = BACKBONE.get("resnet18")(num_classes=10, dtype=torch.float32).cuda().train()
    x = torch.randn((4, 64, 64, 3), device="cuda", generator=card)

    def step(cross_replica):
        norm.set_cross_replica(model, cross_replica)
        model.zero_grad()
        logits = model(x)["logits"]
        logits.square().sum().backward()
        return logits.detach(), {n: p.grad.clone() for n, p in model.named_parameters()}

    state = {k: v.clone() for k, v in model.state_dict().items()}
    want_logits, want_grads = step(False)
    want_state = {k: v.clone() for k, v in model.state_dict().items()}
    model.load_state_dict(state)
    monkeypatch.setattr(norm, "world", lambda: (0, 2))
    monkeypatch.setattr(norm, "all_reduce_sum", lambda t: t)
    layouts, backward = [], norm._GlobalBatchNorm.backward

    def recording(ctx, dy, *rest):
        layouts.append(dy.is_contiguous(memory_format=torch.channels_last))
        return backward(ctx, dy, *rest)

    monkeypatch.setattr(norm._GlobalBatchNorm, "backward", staticmethod(recording))
    _build.reset_launches()
    logits, grads = step(True)
    torch.cuda.synchronize()
    n_bn = sum(isinstance(m, norm.BatchNorm) for m in model.modules())
    assert {k: _build.LAUNCHES[k] for k in BN_KERNELS} == dict.fromkeys(BN_KERNELS, n_bn)
    assert layouts == [True] * n_bn
    assert _rel(logits, want_logits) <= 1e-4
    for name, g in want_grads.items():
        assert _rel(grads[name], g) <= 1e-4, name
    for name, v in model.named_buffers():  # the running statistics
        assert _rel(v, want_state[name]) <= 1e-4, name
