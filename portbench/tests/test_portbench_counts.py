"""The FLOP and byte counts against hand counts."""

from __future__ import annotations

import pytest

from portbench import peaks
from portbench.reference import baseline_resnet50_448 as resnet
from portbench.reference import bcnn_vgg16_s2 as bcnn

# VGG-16 at 448: sum over convs of s^2 * c_in * c_out
#   448^2 (3*64 + 64*64)              =   860,618,752
#   224^2 (64*128 + 128*128)          = 1,233,125,376
#   112^2 (128*256 + 2*256*256)       = 2,055,208,960
#    56^2 (256*512 + 2*512*512)       = 2,055,208,960
#    28^2 (3*512*512)                 =   616,562,688
#   total 6,820,724,736, times 2 * 9  = 122,773,045,248 FLOP
# Gram 2 * 196 * 512^2 = 102,760,448; classifier 2 * 512^2 * 200 = 104,857,600
VGG_CONVS = 122_773_045_248
BCNN_FORWARD = VGG_CONVS + 102_760_448 + 104_857_600
# train: forward x 3 less the first conv's data gradient, 18 * 448^2 * 3 * 64
BCNN_TRAIN = 3 * BCNN_FORWARD - 693_633_024
# pool inputs a image: 448^2*64 + 224^2*128 + 112^2*256 + 56^2*512 + 28^2*512
POOL_IN = 24_485_888


def test_bcnn_flops():
    assert bcnn.forward_flops_per_image() == BCNN_FORWARD == 122_980_663_296
    assert bcnn.train_flops_per_image() == BCNN_TRAIN == 368_248_356_864


def test_bcnn_kernel_work_matches_the_kernels_bounds():
    # forward: bf16 input read, bf16 output and uint8 code written (1/4 each)
    assert bcnn.KERNEL_WORK["pool_fwd_kernel"](8, 448) == (8 * 67_336_192, 0, 5)
    assert 2 * POOL_IN + 3 * POOL_IN // 4 == 67_336_192
    # backward: bf16 output gradient, code, bf16 output read; input gradient written
    assert bcnn.KERNEL_WORK["pool_bwd_kernel"](8, 448) == (8 * 79_579_136, 0, 5)
    # Gram: bf16 [B, 196, 512] read, float32 [B, 512, 512] written
    nbytes, flops, launches = bcnn.KERNEL_WORK["gram_signed_sqrt"](128, 448)
    assert (nbytes, flops, launches) == (128 * 1_249_280, 128 * 102_760_448, 1)
    # the bounds recorded with the kernels: 0.1608 / 0.1900 ms at B = 8, the
    # Gram's 0.0477 ms at B = 128
    assert peaks.bound_s(8 * 67_336_192, 0) * 1e3 == pytest.approx(0.1608, abs=1e-4)
    assert peaks.bound_s(8 * 79_579_136, 0) * 1e3 == pytest.approx(0.1900, abs=1e-4)
    assert peaks.bound_s(nbytes, flops) * 1e3 == pytest.approx(0.0477, abs=1e-4)


def test_resnet50_flops():
    # the published 4.09 GMAC a 224x224 image (torchvision's ResNet-50 with
    # its 1000-way head), four times at 448, two FLOP a MAC, with a 200-way
    # head in place of the 1000-way one
    head224 = 2048 * 1000
    convs448 = 4 * (4_089_184_256 - head224) * 2
    assert resnet.forward_flops_per_image() == pytest.approx(convs448 + 2 * 2048 * 200, rel=2e-3)
    stem_dgrad = 2 * 224 * 224 * 3 * 64 * 49
    assert resnet.train_flops_per_image() == 3 * resnet.forward_flops_per_image() - stem_dgrad
    assert resnet.KERNEL_WORK == {}
