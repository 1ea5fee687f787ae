"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here needs a CUDA device and nvcc and skips without them;
the file imports no JAX, so it runs where only PyTorch is installed:

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py

Pool values, codes and gradients must be bit-exact; the Gram within
rtol 1e-4 / atol 1e-5 of the plain float32 product (accumulation order and
the bf16 kernel's approximate square root)."""

import torch_threads  # noqa: F401  (PyTorch's thread count: see the module)
import pytest
import torch

from hawkeye_tpu_torch.ops import _build
from hawkeye_tpu_torch.ops import fused_bilinear, pool

pytestmark = pytest.mark.cuda


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
