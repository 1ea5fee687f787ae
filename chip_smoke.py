#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``hawkeye_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script
exits non-zero:

1. env: torch, CUDA, nvcc and Triton versions, the card's name and power
   limit.
2. build: compile every kernel in ``hawkeye_tpu_torch/csrc`` (nvcc, sm_90a)
   and count each library's tensor-core (HGMMA) and TMA (UTMALDG, UTMASTG)
   instructions with ``cuobjdump -sass``; the Gram library must have HGMMA.
3. kernels: each kernel against its plain PyTorch version at the slice's
   shapes (BCNN VGG-16, 448x448, bf16): pool values, codes and ``dx``
   bit-exact at batch 8, plus a constructed-ties and an all-negative case;
   the Gram at batch 8 and 128 within rtol 1e-4 / atol 1e-5 of the plain
   float32 product of the same bf16 inputs (accumulation order, and the
   kernel's hardware square root, relative error below 2^-22).
   Kernel, plain and library times are device times (CUDA-graph replays
   between CUDA events); the bound from the bytes and operations the
   function needs at this card's published peaks. The Gram's library call
   is one ``torch.bmm`` with float32 output plus the epilogue, the same
   function; the bf16-output ``bmm`` (which rounds the Gram to bf16 before
   the epilogue) is reported beside it.
4. reference: a small BCNN (VGG-16, 64x64, float32, TF32 off) on the card,
   through the kernels, against the same weights on the CPU: logits within
   1e-4 and gradients within 1e-2 of the largest value.
5. slice: BCNN VGG-16 at 448x448, 200 classes, synthetic data, through the
   port's Trainer: stage 1 from ``configs/BCNN_S1.yaml`` (batch 8, a few
   steps, one epoch, writes best_model), then stage 2 from
   ``configs/BCNN_S2.yaml`` with ``model.load`` at that file and
   ``fused_pooling: true``. Launch counts are set to 0 before each stage and
   read after it; stage 2 must launch all three kernels.
6. throughput: the stage-2 train step at batch 128, 448x448, bf16; 3 warm-up
   and 10 timed steps, synchronised at each end.
7. reference_resnet: Baseline ResNet-18 and ResNet-50 (64x64, batch 4, one
   seed, TF32 off), one train-mode forward and backward on the card and on
   the CPU: logits within 1e-4, the first-conv and ``fc`` gradients within
   1e-2 and ``bn1``'s running mean and variance within 1e-4 of the largest
   value. In float32 for both; ResNet-50's gradients are held to 1e-2 in
   float64 on both devices, since its float32 gradients are only good to a
   few 1e-2 at this size (the phase prints the CPU's own float32 against
   float64 beside the card's float32 against the CPU's).
8. slice_resnet: Baseline ResNet-50 at 448x448 (``configs/Baseline.yaml``:
   batch 24, Adam; synthetic data, 200 classes, ``dataset.pipeline: device``
   with TA-wide, ``resize_size`` 512) through the port's Trainer, one epoch
   of 4 steps, then the Tester on the saved best model and the same val
   split: its top-1 must equal the Trainer's last val accuracy; finite
   losses, running statistics that moved, and no launch of the three
   kernels.
9. throughput_resnet: ``resnet50_train_images_per_sec`` as ``bench.py``
   defines it: Baseline ResNet-50, 448x448, batch 128, 200 classes, SGD (lr
   0.01, momentum 0.9, weight decay 1e-4), bf16 compute, the device
   pipeline's augmentation (crop with the flip, normalize, erase 0.1, no
   TA-wide, bf16 out) on device-resident uint8 [128, 512, 512, 3] inputs,
   one per step; 3 warm-up and 10 timed steps, synchronised at each end.
   Then ``resnet50_eval_images_per_sec``: the eval forward at batch 256 on a
   512->448 center crop normalised in bf16, as ``bench.py`` times it.

10. kernels_highorder_shapes: the three kernels at the shapes the new paths
    give them: the pool kernels on VGG-16's maps at 448x448, batch 16
    (CBCNN stage 2) and at 224x224, batch 16 (Peer-Learning, CBCNN stage
    1), bit-exact; the Gram at x [16, 49, 512] bf16 (Peer-Learning's fused
    heads, K = 49) within the Gram tolerances; kernel, plain and library
    times and bounds as phase 3.
11. reference_highorder: CBCNN (VGG-16, 64x64, d = 6000) on the card
    against the CPU: float32 logits within 1e-4 of the largest value, and
    the whole model in float64 (trunk, head and classifier) with logits and
    gradients within 1e-8; the float32 gradients are printed beside, with
    a float64 trunk under the float32 head and the CPU's own float32
    against float64. MPN on ResNet-50 (64x64, reduction 256), one
    train-mode step: in float64 (the head is float32 either way) logits and
    ``dr_bn``'s running variance within 1e-4, gradients within 1e-2; the
    float32 logits within 1e-3 (the CPU's own float32 run is ~5e-4 from its
    float64 one, printed beside). The Peer-Learning kept masks identical and
    both losses within 1e-6, at every agreement count of a batch of 16 and
    every value of a T_k = 10 drop-rate ramp.
12. slice_highorder: each recipe through its Example trainer
    (``hawkeye_tpu_torch/examples``) at its recipe's shape, synthetic data,
    200 classes, one epoch of 32 images (a quarter of that for val): CBCNN
    S1 (224x224) -> S2 (448x448, batch 16, d = 6000) via ``model.load``,
    then the Tester on the S2 best model (top-1 and logits equal to the
    Trainer's); MPN (ResNet-50, 224x224, batch 8; its groups' LRs at 0.2x
    and 1x); Peer-Learning S1 -> S2 (two BCNN VGG-16 peers, 224x224, batch
    16; S2 with ``model.base_model.fused_pooling: true``; acc1/acc2 filled);
    Pairwise Confusion (Baseline ResNet-50, 224x224, batch 24). Finite
    losses; launch counts set to 0 before each stage, read after it and
    held to exact values: pool kernels in CBCNN S1 (forward only) and S2,
    all three in Peer-Learning S2 (the Gram twice per forward), none in MPN
    and Pairwise Confusion.
13. throughput_highorder: 3 warm-up and 10 timed train steps of each recipe
    at its shape, on ``profile_step``'s benchmark trainer and batches for it
    (CBCNN and Peer-Learning at stage 2, Peer-Learning with drop rate 0.25;
    device-resident float inputs), synchronised at each end:
    ``cbcnn_train_images_per_sec``, ``mpn_train_images_per_sec``,
    ``peer_learning_train_images_per_sec`` and
    ``pair_confusion_train_images_per_sec`` with peak memory, one line each.
    CBCNN's line also times its head's inverse transform both ways at the
    recipe's shape: the irDFT matmuls the port runs and ``torch.fft.irfft``.
14. reference_pairs: OSME (ResNet-101, 64x64, batch 4), API-Net
    (ResNet-101, 64x64, batch 6, dropout off: the two devices draw other
    masks), CIN (ResNet-50, 64x64, batch 4), CrossX (64x64, batch 2) and
    Interp-Parts (IP-ResNet-101, 96x96, batch 4, K = 5, soft assignments,
    see ``_soften``) on the card against the CPU, one train-mode step
    through each method's loss with BatchNorm scales and biases at random,
    TF32 off: with the whole model in float64, logits and every gradient
    within 1e-6 of the tensor's largest value and API-Net's mined partners
    equal (``attconv_out``'s bias, 0 in exact arithmetic, below 1e-6 of the
    largest gradient); in float32, logits within 1e-3 (Interp-Parts' 1e-2:
    they come through a BatchNorm over the batch of 4); the float32
    gradients are printed: BatchNorm at small batches makes them a reading
    of rounding.
15. slice_pairs: each recipe through its Example trainer at its recipe's
    shape, synthetic data, 200 classes, four full train batches (a P x K
    recipe draws its labels from P classes so that every batch is full):
    OSME (``configs/OSMENet.yaml``, ResNet-101, 224x224, 5 x 2), API-Net
    (``APINet.yaml``, ResNet-101, 224x224, 10 x 4, Adam), CIN
    (``CIN.yaml``, ResNet-50, 224x224, 4 x 5), CrossX (``CrossX.yaml``,
    448x448, batch 8) and Interp-Parts (``InterpPartsNet.yaml``,
    IP-ResNet-101, 448x448, batch 16, its groups at 1x and 20x); then the
    Tester on each best model (top-1 and logits equal to the Trainer's).
    Finite losses; every kernel's launch count 0 in training and testing.
16. throughput_pairs: ``osme_``, ``apinet_``, ``cin_``, ``crossx_`` and
    ``interp_parts_train_images_per_sec`` as phase 13 times them, on
    ``profile_step``'s trainer and batches at the recipes' shapes (P x K
    labels; API-Net past its epoch-0 gate), no kernel launch.
17. reference_tree_dcl: ProtoTree (ResNet-50, 64x64, batch 4, height 9,
    D = 256; prototypes near the batch's features and leaves at random, so
    that the walks turn both ways) and DCL
    (ResNet-50, 128x128: a 2x2 mask and a 4-cell law; 2 images, 4 rows of
    its host collate) on the card against the CPU, one train-mode step
    through each method's loss, BatchNorm scales and biases at random,
    TF32 off: with the whole model in float64, logits and every gradient
    within 1e-6 of the tensor's largest value, ProtoTree's leaf update
    within 1e-10 and its sample_max and greedy leaves (of a train-mode
    forward) identical; in
    float32, logits within 1e-3 (gradients printed).
18. slice_tree_dcl: ProtoTree through its Example trainer at
    ``configs/ProtoTreeNet.yaml``'s shape (ResNet-50, 224x224, batch 64,
    height 9, D = 256, AdamW, warm-up cosine), synthetic data, 200
    classes, ``model.backbone.pretrain`` at a ``.pth`` the phase writes
    from a seeded torchvision-layout ResNet-50 state dict (the log must
    show its tensors loaded), two epochs of two steps with
    ``FREEZE_EPOCHS`` 1 (backbone unchanged in epoch 0, moved in epoch 1,
    leaves moved in both), ``save_tree``/``load_tree`` logits equal; DCL at
    ``configs/DCL.yaml``'s (ResNet-50, 448x448, batch 8 -> 16 rows, SGD,
    the head at 10x the LR), four steps with the host pipeline, then with
    ``dataset.pipeline: device``. After each, the Tester on the best model
    (top-1 and logits equal to the Trainer's). Finite losses; every
    kernel's launch count 0.
19. throughput_tree_dcl: ``prototree_train_images_per_sec`` (batch 64,
    224x224, epoch 0's step) and ``dcl_train_images_per_sec`` (batch 8 at
    448x448; it counts the 16 rows ``[unswapped; swapped]`` the model sees,
    as ``bench_methods.py`` counts DCL) as phase 13 times them, on
    ``profile_step``'s trainer and batches, no kernel launch.

20. reference_region: NTS-Net (ResNet-18, 64x64, batch 4,
    ``pad_side = part_size = 64``, M = 6, K = 4, dropout off: the two
    devices draw other masks) on its sequential path and with
    ``fused_part_pass``, and AP-CNN (the recipe's ResNet-50, 64x64, batch 4,
    the dropblock on fixed draws), 200 classes, on the card against the
    CPU, one train-mode step through each method's loss, BatchNorm scales
    and biases at random, TF32 off: with the whole model in float64, logits,
    every gradient and every running statistic within 1e-8 of the tensor's
    largest value (AP-CNN's heads' ``bn1``/``fc1`` biases, 0 in exact
    arithmetic, below 1e-8 of the largest gradient), the greedy picks
    (NTS-Net's anchors per forward, AP-CNN's ``rois``) identical, and the
    card's fused path against its sequential path to the same 1e-8 with
    the same picks; the float32 readings are printed, with the count of
    rows whose picks differ.
21. slice_region: NTS-Net through its Example trainer at
    ``configs/NTSNet.yaml``'s shape (ResNet-50, 224x224, batch 4, M = 6,
    K = 4, Adam with its warm-up cosine) and AP-CNN at ``configs/APCNN.yaml``'s
    (ResNet-50, 448x448, batch 8, SGD, the trunk group at 0.1x the heads'
    LR), synthetic data, 200 classes, one epoch of four steps with
    validation; the Tester on each best model (top-1 equal to the trainer's,
    logits equal to the trained model's); finite losses; every kernel's
    launch count 0; and one train forward and backward of each model under
    ``torch.cuda.set_sync_debug_mode("error")``: the proposals, NMS, crops
    and dropblock wait on nothing from the host.
22. throughput_region: ``ntsnet_train_images_per_sec`` (batch 4 at
    224x224; it counts the 4 images of a step, not the 4 + 24 backbone
    rows) and ``apcnn_train_images_per_sec`` (batch 8 at 448x448) as phase
    13 times them, on ``profile_step``'s trainer and batches, no kernel
    launch.
23. reference_s3n_mge: S3N (ResNet-18, 128x128, batch 4, fused warp pass) at
    each phase p = 0, 1, 2 (phase 1's uniform draws fixed) and MGE-CNN
    (four ResNet-18s, 64x64, batch 4; a train step with the labels, then an
    eval forward whose CAMs follow each expert's argmax), 200 classes, on
    the card against the CPU, one train-mode step through each method's
    loss, BatchNorm scales and biases at random, TF32 off: with the whole
    model in float64, logits, every gradient and every running statistic
    within 1e-8 of the tensor's largest value, S3N's zoom and inverse peak
    masks and MGE's crop boxes identical; S3N's two-pass form on the card
    against its fused pass to the same 1e-8 at each phase; the float32
    readings are printed.
24. slice_s3n_mge: S3N through its Example trainer at ``configs/S3N.yaml``'s
    shape (ResNet-50, 448x448, batch 8, bf16, SGD; the classifiers at 1x,
    the radii and the blur kernel at 1e-5x, the rest at 0.1x the LR): one
    train step and a validation at epoch 0 (train phase 0, validation phase
    1), then at epoch 20 (1 and 2); MGE-CNN at ``configs/MGE_CNN.yaml``'s
    (four ResNet-50s, 224x224, batch 4, Adam, the backbones at 0.1x), one
    epoch of four steps with validation; synthetic data, 200 classes. The
    Tester on each best model (its top-1 equal to the trained model's at
    the Tester's call, S3N's phase 0; logits equal to the trained
    model's); finite losses; every kernel's launch count 0; one train
    forward and backward of each under
    ``torch.cuda.set_sync_debug_mode("error")``.
25. throughput_s3n_mge: ``s3n_train_images_per_sec`` (batch 8 at 448x448,
    a phase-1 step) and ``mge_cnn_train_images_per_sec`` (batch 4 at
    224x224) as phase 13 times them, with the peak memory, and the device
    idle share and kernel time by category of ``profile_step``'s profile
    of 5 steps (``saliency``, ``warp``, ``cam_crop``), no kernel launch.

26. native_decoder: the native JPEG decoder built from the checkout (g++
    and libjpeg on this machine); seeded CUB-sized JPEGs (500x375 and
    375x500) decoded at 512 by ``FGDataset(decode_size=512)``, its bytes the
    native decoder's and within the JAX test's mean tolerance of PIL's;
    host decode images/s, native and PIL, at the Baseline recipe's loader
    thread count and at one thread per core. Where the decoder cannot be
    built, the dataset's bytes must be PIL's and the reason is printed.
27. reference_vgg_bn: BCNN on VGG-16-BN (64x64, batch 4, float64,
    BatchNorm at random) on the card against the CPU, logits, gradients and
    running statistics within 1e-8 of the largest value; ``fast_dgrad``'s
    ``dx`` and ``dw`` against autograd in float64; the VGG-16-BN
    classifier's eval forward at 224x224 against the CPU in float64.
28. slice_vgg_bn: BCNN S1 -> S2 on ``model.backbone: vgg16_bn`` at
    448x448, batch 8, through the BCNN Example trainer, each stage's
    launches equal to the plain BCNN's (phase 5); stage 2 with
    ``experiment.profile: true`` (its trace file must exist) and the Tester
    equal to the trained model; one stage-2 step with ``model.fast_dgrad:
    true`` on plain VGG-16.
29. throughput_vgg_bn: ``bcnn_bn_train_images_per_sec`` at 448x448, batch
    128 and 8, with peak memory, the device idle share and time by
    category (``profile_step --model bcnn_bn``).
30. distributed: one Baseline-shaped step at a global batch of 16 on two
    ranks (this script with ``--distributed-worker``, gloo over CUDA tensors
    on the one card: NCCL refuses two ranks on one device) against one
    process at 16 from the same weights: in float64 (ResNet-18, 64x64, a
    float64 head, SGD) every update and running statistic within 1e-10;
    the Baseline recipe's ResNet-50 at 448x448 (bf16, Adam), the agreement
    printed.
31. mge_fused: MGE-CNN's ``fused_experts`` against its sequential path on
    the card in float64 within 1e-10 (logits, gradients, statistics; the
    boxes identical), then ``mge_cnn_fused_train_images_per_sec`` beside
    the sequential ``mge_cnn_train_images_per_sec`` at batch 4, 224x224.
32. mixup: Mixup and CutMix on the card against the CPU at the same draws
    (b32, 448x448): within 1e-6, the masks identical.

Then a ``kernels`` JSON line (pool kernels at batch 8; the Gram at batch
128, where its 134 MB output cannot stay in the 50 MB L2 between replays;
``launches`` summed over the BCNN stage 2, the new recipes' stages and
the VGG-16-BN stages),
the ``nvidia-smi`` name and power-limit line,
and as the last line ``{"ok": true, "device": {...}}``. Without a CUDA
device, or without the package beside it, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# NVIDIA H100 SXM data sheet: HBM3 bytes/s, dense bf16 tensor-core FLOP/s,
# float32 FLOP/s outside the tensor cores
PEAK_BYTES_S = 3.35e12
PEAK_BF16_S = 989e12
PEAK_F32_S = 67e12

B = 8
# Peer-Learning's and CBCNN stage 1's VGG-16 pool inputs at 224x224, batch
# 16, and the Gram input of each fused BCNN peer there (7x7 post-pool5 map)
PL_POOL_SHAPES = [(16, 224, 224, 64), (16, 112, 112, 128), (16, 56, 56, 256),
                  (16, 28, 28, 512), (16, 14, 14, 512)]
PL_GRAM_SHAPE = (16, 49, 512)
# CBCNN stage 2's VGG-16 pool inputs at 448x448, batch 16
CB_POOL_SHAPES = [(16, 448, 448, 64), (16, 224, 224, 128), (16, 112, 112, 256),
                  (16, 56, 56, 512), (16, 28, 28, 512)]
POOL_SHAPES = [(B, 448, 448, 64), (B, 224, 224, 128), (B, 112, 112, 256),
               (B, 56, 56, 512), (B, 28, 28, 512)]
GRAM_SHAPES = [(B, 196, 512), (128, 196, 512)]  # recipe batch, throughput batch
GRAM_RTOL, GRAM_ATOL = 1e-4, 1e-5
# per element of a bf16 pool input x: the forward reads x (2 bytes) and
# writes p (1/2) and codes (1/4); the backward reads dp, p (1/2 each) and
# codes (1/4) and writes dx (2). ~7 float32 compare/max per pooled value.
POOL_FWD_BYTES, POOL_BWD_BYTES, POOL_OPS = 2.75, 3.25, 7 / 4
# CBCNN in float64 on the card against the CPU, relative to the largest value
CB_F64_TOL = 1e-8


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def cuda_ms(torch, fn, iters=20, warmup=3, replays=5):
    """Mean device milliseconds per call of ``fn``: ``iters`` calls captured
    in one CUDA graph, replayed ``replays`` times between two CUDA events.
    The host's cost per call (argument checks, allocation, the launch) does
    not count, so a small kernel reads its device time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (iters * replays)
    del graph
    return ms


def sass_counts(lib_path, nvcc):
    """Tensor-core and TMA instructions in a built library's SASS."""
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    return {op: sum(ln.count(op) for ln in sass.splitlines())
            for op in ("HGMMA", "UTMALDG", "UTMASTG")}


def bound(bytes_moved, ops, peak_ops):
    t_bytes = bytes_moved / PEAK_BYTES_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _pool_case(torch, shape, gen):
    """The pool kernels at one shape: bit-exact against their plain versions,
    then kernel, plain and library device times and the bounds."""
    import torch.nn.functional as F

    from hawkeye_tpu_torch.ops import pool

    x = torch.randn(shape, device="cuda", generator=gen).to(torch.bfloat16)
    p, idx = pool.pool_fwd(x)
    p_ref, idx_ref = pool.pool_fwd_plain(x)
    dp = torch.randn(p.shape, device="cuda", generator=gen).to(torch.bfloat16)
    if not (torch.equal(p, p_ref) and torch.equal(idx, idx_ref) and torch.equal(
            pool.pool_bwd(dp, idx, p), pool.pool_bwd_plain(dp, idx, p))):
        raise AssertionError(f"pool kernels differ from plain at {shape}")
    del p_ref, idx_ref
    # the library's yardsticks (the port calls neither): relu then
    # max_pool2d with indices on channels-last, and max_pool2d's backward
    x_cl, dp_cl = x.permute(0, 3, 1, 2), dp.permute(0, 3, 1, 2)
    xr_cl = F.relu(x_cl)
    lib_idx = F.max_pool2d(xr_cl, 2, 2, return_indices=True)[1]
    n = x.numel()
    row = {"shape": list(shape),
           "fwd_ms": cuda_ms(torch, lambda: pool.pool_fwd(x)),
           "fwd_plain_ms": cuda_ms(torch, lambda: pool.pool_fwd_plain(x)),
           "fwd_library_ms": cuda_ms(torch, lambda: F.max_pool2d(
               F.relu(x_cl), 2, 2, return_indices=True)),
           "fwd_bound_ms": bound(POOL_FWD_BYTES * n, POOL_OPS * n, PEAK_F32_S)[0],
           "bwd_ms": cuda_ms(torch, lambda: pool.pool_bwd(dp, idx, p)),
           "bwd_plain_ms": cuda_ms(torch, lambda: pool.pool_bwd_plain(dp, idx, p)),
           "bwd_library_ms": cuda_ms(
               torch, lambda: torch.ops.aten.max_pool2d_with_indices_backward(
                   dp_cl, xr_cl, [2, 2], [2, 2], [0, 0], [1, 1], False, lib_idx)),
           "bwd_bound_ms": bound(POOL_BWD_BYTES * n, POOL_OPS * n, PEAK_F32_S)[0]}
    del x, p, idx, dp, x_cl, dp_cl, xr_cl, lib_idx
    torch.cuda.empty_cache()
    return row


# ----------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ----------------------------------------------------------------------------
def check_kernels(torch):
    from hawkeye_tpu_torch.ops import fused_bilinear, pool
    from hawkeye_tpu_torch.ops.bilinear import ssqrt

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    dev = "cuda"
    bf16 = torch.bfloat16
    rows = {"pool_fwd": dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0.0,
                             ops=0.0, max_abs_err=0.0),
            "pool_bwd": dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bytes=0.0,
                             ops=0.0, max_abs_err=0.0)}
    per_shape = []
    for shape in POOL_SHAPES:
        r = _pool_case(torch, shape, gen)
        per_shape.append(r)
        n = math.prod(shape)
        for name, key, byt in (("pool_fwd", "fwd", POOL_FWD_BYTES * n),
                               ("pool_bwd", "bwd", POOL_BWD_BYTES * n)):
            row = rows[name]
            for k in ("ms", "plain_ms", "library_ms"):
                row[k] += r[f"{key}_{k}"]
            row["bytes"] += byt
            row["ops"] += POOL_OPS * n

    # constructed ties (coarse grid) and all-negative windows
    x = (torch.round(torch.randn((B, 56, 56, 512), device=dev, generator=gen)
                     * 2) / 2).to(bf16)
    x[:, :8] = -x[:, :8].abs() - 0.5
    p, idx = pool.pool_fwd(x)
    p_ref, idx_ref = pool.pool_fwd_plain(x)
    dp = torch.randn(p.shape, device=dev, generator=gen).to(bf16)
    ties_ok = (torch.equal(p, p_ref) and torch.equal(idx, idx_ref)
               and torch.equal(pool.pool_bwd(dp, idx, p),
                               pool.pool_bwd_plain(dp, idx, p)))
    neg = -(torch.rand((2, 8, 8, 64), device=dev, generator=gen) + 0.1).to(bf16)
    pn, idxn = pool.pool_fwd(neg)
    dxn = pool.pool_bwd(torch.ones_like(pn), idxn, pn)
    neg_ok = (float(pn.float().abs().sum()) == 0.0
              and float(dxn.float().abs().sum()) == 0.0
              and torch.equal(idxn, pool.pool_fwd_plain(neg)[1]))
    if not (ties_ok and neg_ok):
        raise AssertionError(f"pool edge cases: ties {ties_ok}, negative {neg_ok}")

    # gram + signed sqrt: features after ReLU are non-negative
    gram_shapes = []
    for shape in GRAM_SHAPES:
        xg = torch.relu(torch.randn(shape, device=dev, generator=gen)).to(bf16)
        y = fused_bilinear.gram_signed_sqrt_forward(xg)
        y_ref = fused_bilinear.gram_signed_sqrt_plain(xg)
        torch.cuda.synchronize()
        err = (y - y_ref).abs()
        if not bool((err <= GRAM_ATOL + GRAM_RTOL * y_ref.abs()).all()):
            raise AssertionError(f"gram_signed_sqrt max err {float(err.max())} "
                                 f"at {shape}")
        bg, hw, c = shape
        xt = xg.transpose(1, 2)
        byt = bg * hw * c * 2 + bg * c * c * 4
        r = dict(
            ms=cuda_ms(torch, lambda: fused_bilinear.gram_signed_sqrt_forward(xg)),
            plain_ms=cuda_ms(torch, lambda: fused_bilinear.gram_signed_sqrt_plain(xg)),
            # the library's yardsticks (the port calls neither): one bmm on
            # the bf16 tensor cores with float32 output, plus the epilogue;
            # and the bf16-output bmm, which rounds the Gram to bf16 first
            library_ms=cuda_ms(torch, lambda: ssqrt(
                torch.bmm(xt, xg, out_dtype=torch.float32) / hw)),
            library_bf16_out_ms=cuda_ms(
                torch, lambda: ssqrt(torch.bmm(xt, xg).float() / hw)),
            bytes=byt, ops=2 * bg * hw * c * c, max_abs_err=float(err.max()))
        bms, by = bound(r["bytes"], r["ops"], PEAK_BF16_S)
        gram_shapes.append(dict(shape=list(shape), bound_ms=bms, bound_by=by,
                                gb_per_s=byt / r["ms"] / 1e6,
                                share_of_bound=bms / r["ms"], **r))
        del xg, y, y_ref, err, xt
        torch.cuda.empty_cache()
    rows["gram_signed_sqrt"] = dict(gram_shapes[-1])

    out = {}
    for name, r in rows.items():
        peak = PEAK_BF16_S if name == "gram_signed_sqrt" else PEAK_F32_S
        bms, by = bound(r["bytes"], r["ops"], peak)
        out[name] = dict(ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=bms,
                         bound_us=bms * 1e3, bound_by=by,
                         library_ms=r["library_ms"],
                         max_abs_err=r["max_abs_err"])
    emit("kernels_vs_plain", batch=B, dtype="bfloat16", pool_shapes=per_shape,
         pool_edge_cases_bit_exact=True, gram_rtol=GRAM_RTOL,
         gram_atol=GRAM_ATOL, gram_shapes=gram_shapes, **out)
    return out


# ----------------------------------------------------------------------------
# phase 4: small float32 reference, card against CPU
# ----------------------------------------------------------------------------
def check_reference(torch):
    from hawkeye_tpu_torch.engine.trainer import set_tf32
    from hawkeye_tpu_torch.models import init_parameters
    from hawkeye_tpu_torch.models.methods.bcnn import BCNN

    set_tf32(False)
    gen = torch.Generator()
    gen.manual_seed(1)
    x = torch.randn((2, 64, 64, 3), generator=gen)
    y = torch.tensor([3, 7])
    results = {}
    for dev in ("cpu", "cuda"):
        m = BCNN(num_classes=10, backbone_name="vgg16", fused_pooling=True,
                 dtype=torch.float32)
        g = torch.Generator()
        g.manual_seed(2)
        init_parameters(m, g)
        m.to(dev)
        logits = m(x.to(dev))["logits"]
        loss = torch.nn.functional.cross_entropy(logits, y.to(dev))
        loss.backward()
        results[dev] = (logits.detach().cpu(),
                        m.backbone.features["0"].weight.grad.cpu(),
                        m.fc.weight.grad.cpu())
    # logits to 1e-4 of their largest value; gradients to 1e-2: a ReLU or a
    # window's argmax can flip on a near-tie between cuDNN's and the CPU's
    # float32 sums, and the first conv's gradient gathers all such flips
    errs = {}
    for name, tol, (a, b) in zip(("logits", "conv0_grad", "fc_grad"),
                                 (1e-4, 1e-2, 1e-2),
                                 zip(results["cuda"], results["cpu"])):
        errs[name] = float((a - b).abs().max()) / float(b.abs().max())
        if errs[name] > tol:
            raise AssertionError(f"card vs CPU {name}: relative err {errs[name]}")
    emit("reference", model="BCNN vgg16 64x64 float32 fused, TF32 off",
         rel_err_of_max=errs)


# ----------------------------------------------------------------------------
# phase 7: small ResNet reference, card against CPU
# ----------------------------------------------------------------------------
def check_reference_resnet(torch):
    import torch.nn.functional as F

    from hawkeye_tpu_torch.engine.trainer import set_tf32
    from hawkeye_tpu_torch.models import init_parameters
    from hawkeye_tpu_torch.models.methods.baseline import BaselineClassifier

    set_tf32(False)
    gen = torch.Generator()
    gen.manual_seed(4)
    x = torch.randn((4, 64, 64, 3), generator=gen)
    y = torch.tensor([3, 7, 1, 0])
    names = ("logits", "conv1_grad", "fc_grad", "bn1_running_mean",
             "bn1_running_var")
    tols = dict(zip(names, (1e-4, 1e-2, 1e-2, 1e-4, 1e-4)))

    def step(name, dtype, dev):
        m = BaselineClassifier(name, 10, dtype=dtype)
        init_parameters(m, torch.Generator().manual_seed(5))
        m.backbone.to(dtype)  # the float32 head reads the float32 pool
        m.to(dev).train()
        logits = m(x.to(dev, dtype))["logits"]
        F.cross_entropy(logits, y.to(dev)).backward()
        bb = m.backbone
        return [t.detach().double().cpu() for t in (
            logits, bb.conv1.weight.grad, m.fc.weight.grad, bb.bn1.running_mean,
            bb.bn1.running_var)]

    def rel(a, b):
        return {n: float((u - v).abs().max() / v.abs().max())
                for n, u, v in zip(names, a, b)}

    f32, f64 = torch.float32, torch.float64
    cases = {"resnet18_float32": ("resnet18", f32, names),
             "resnet50_float32": ("resnet50", f32, ("logits", "fc_grad",
                                                    "bn1_running_mean",
                                                    "bn1_running_var")),
             "resnet50_float64": ("resnet50", f64, names)}
    errs, cpu_runs = {}, {}
    for case, (name, dtype, checked) in cases.items():
        cpu_runs[case] = step(name, dtype, "cpu")
        errs[case] = rel(step(name, dtype, "cuda"), cpu_runs[case])
        for n in checked:
            if errs[case][n] > tols[n]:
                raise AssertionError(f"card vs CPU {case} {n}: relative err "
                                     f"{errs[case][n]}")
    cpu_f32_vs_f64 = rel(cpu_runs["resnet50_float32"], cpu_runs["resnet50_float64"])
    emit("reference_resnet", model="Baseline ResNet-18/50 64x64 batch 4, one "
         "train-mode step, TF32 off", tolerances=tols, rel_err_of_max=errs,
         resnet50_cpu_float32_vs_float64=cpu_f32_vs_f64)


# ----------------------------------------------------------------------------
# phases 5 and 6: the slice through the Trainer, then throughput
# ----------------------------------------------------------------------------
def _recipe(name, run_dir, overrides):
    import yaml

    def merge(base, over):
        for k, v in over.items():
            if isinstance(v, dict) and isinstance(base.get(k), dict):
                merge(base[k], v)
            else:
                base[k] = v

    with open(os.path.join(ROOT, "configs", name)) as f:
        recipe = yaml.safe_load(f)
    merge(recipe, overrides)
    for k in ("root_dir", "meta_dir"):
        recipe["dataset"].pop(k, None)
    path = os.path.join(run_dir, name)
    with open(path, "w") as f:
        yaml.safe_dump(recipe, f)
    return path


class _Recorder:
    """Keeps the Trainer's last epoch report (``report`` is its hook)."""

    def report(self, epoch, lr, train_metrics, val_metrics, images_per_sec):
        self.last_report = dict(train_loss=train_metrics["loss"],
                                train_acc=train_metrics["acc"],
                                val_loss=val_metrics["loss"],
                                val_acc=val_metrics["acc"],
                                images_per_sec=images_per_sec)


def run_slice(torch, run_dir):
    from hawkeye_tpu_torch.config import setup_config
    from hawkeye_tpu_torch.engine import Trainer
    from hawkeye_tpu_torch.ops import LAUNCHES, reset_launches

    class SmokeTrainer(_Recorder, Trainer):
        pass

    n_train = 32  # 4 train steps; the Trainer's synthetic val split is a
    n_val = n_train // 4  # quarter of it: one batch
    common = {
        "experiment": {"log_dir": run_dir},
        "dataset": {"name": "synthetic", "length": n_train, "num_workers": 8,
                    "num_classes": 200},
        "model": {"num_classes": 200},
        "train": {"epoch": 1},
    }
    s1_cfg = setup_config(argv=["--config", _recipe("BCNN_S1.yaml", run_dir, common)])
    if int(s1_cfg.dataset.batch_size) != B or int(s1_cfg.model.stage) != 1:
        raise AssertionError("configs/BCNN_S1.yaml is no longer batch 8, stage 1")
    reset_launches()
    s1 = SmokeTrainer(s1_cfg)
    s1.train()
    torch.cuda.synchronize()
    s1_launches = dict(LAUNCHES)
    s1_state = {k: v.detach().cpu().clone() for k, v in s1.model.state_dict().items()}
    s1_report = s1.last_report
    s1_best = os.path.join(s1.log_root, "best_model.msgpack")  # recipe's name
    del s1
    torch.cuda.empty_cache()

    s2_over = dict(common, model={"num_classes": 200, "load": s1_best,
                                  "fused_pooling": True})
    s2_cfg = setup_config(argv=["--config", _recipe("BCNN_S2.yaml", run_dir, s2_over)])
    if int(s2_cfg.model.stage) != 2 or not s2_cfg.train.val_first:
        raise AssertionError("configs/BCNN_S2.yaml is no longer stage 2 with val_first")
    reset_launches()
    s2 = SmokeTrainer(s2_cfg)
    loaded = s2.model.state_dict()
    for k, v in s1_state.items():
        if not torch.equal(loaded[k].cpu(), v):
            raise AssertionError(f"stage 2 did not load stage 1's {k}")
    t0 = time.time()
    s2.train()
    torch.cuda.synchronize()
    s2_seconds = time.time() - t0
    s2_launches = dict(LAUNCHES)

    steps = n_train // B
    forwards = steps + 2 * (-(-n_val // B))  # val_first + end-of-epoch val
    want = {"pool_fwd": 5 * forwards, "pool_bwd": 5 * steps,
            "gram_signed_sqrt": forwards}
    if s2_launches != want:
        raise AssertionError(f"stage 2 launches {s2_launches}, expected {want}")
    if s1_launches["pool_fwd"] == 0 or s1_launches["pool_bwd"] != 0:
        raise AssertionError(f"stage 1 launches {s1_launches}")
    r2 = s2.last_report
    for rep in (s1_report, r2):
        for k in ("train_loss", "val_loss"):
            if not math.isfinite(rep[k]):
                raise AssertionError(f"non-finite {k}: {rep}")
    emit("slice", model="BCNN vgg16 448x448 200 classes, synthetic",
         batch=B, stage1=dict(s1_report, launches=s1_launches),
         stage2=dict(r2, launches=s2_launches, train_steps=steps,
                     seconds_with_val=s2_seconds),
         stage2_loaded_stage1_weights=True)
    return s2, s2_launches, s1_launches


def _train_rate(torch, trainer, model, batch, warmup=3, timed=10):
    """Train images (rows the model sees) per second of ``timed`` steps
    after ``warmup``, each on its own device-resident batch from
    ``profile_step.bench_batches`` (the batches ``profile_step --model
    <model>`` profiles), with the peak memory,
    the kernel launches per step and what the batches carry besides images
    and labels (Peer-Learning's drop rate)."""
    from hawkeye_tpu_torch.ops import LAUNCHES, reset_launches
    from hawkeye_tpu_torch.profile_step import bench_batches, bench_lr

    batches = bench_batches(model, batch, timed, seed=3)
    extra = {k: v for k, v in batches[0].items() if not torch.is_tensor(v)}
    rows = batches[0]["img"].shape[0]  # DCL's 2x batch: 2 x batch rows
    lr = bench_lr(trainer)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for i in range(warmup):
        trainer.train_step_call(batches[i], lr)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    for b in batches:
        m = trainer.train_step_call(b, lr)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    loss = float(m["loss"])
    if not math.isfinite(loss):
        raise AssertionError(f"throughput step loss {loss}")
    return dict(images_per_sec=rows * timed / dt, ms_per_step=dt / timed * 1e3,
                batch=batch, rows=rows, image_size=batches[0]["img"].shape[1], **extra,
                warmup_steps=warmup,
                timed_steps=timed, last_loss=loss,
                peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
                launches_per_step={k: v / timed for k, v in LAUNCHES.items()})


def run_throughput(torch, trainer, batch=128):
    rate = _train_rate(torch, trainer, "bcnn", batch)
    if rate["launches_per_step"] != {"pool_fwd": 5, "pool_bwd": 5,
                                     "gram_signed_sqrt": 1}:
        raise AssertionError(f"launches per step {rate['launches_per_step']}")
    emit("throughput", bcnn_train_images_per_sec=rate.pop("images_per_sec"),
         dtype="bfloat16", **rate, device=torch.cuda.get_device_name(0),
         nvidia_smi=nvidia_smi_line())


# ----------------------------------------------------------------------------
# phases 8 and 9: Baseline ResNet-50 through the Trainer and the Tester, then
# throughput
# ----------------------------------------------------------------------------
def run_slice_resnet(torch, run_dir, n_train=96):
    from hawkeye_tpu_torch.config import setup_config
    from hawkeye_tpu_torch.engine import Tester, Trainer
    from hawkeye_tpu_torch.ops import LAUNCHES, reset_launches

    class SmokeTrainer(_Recorder, Trainer):
        pass

    n_val = n_train // 4  # the Trainer's synthetic val split
    data = {"name": "synthetic", "length": n_train, "num_workers": 8,
            "num_classes": 200, "pipeline": "device",
            "transformer": {"image_size": 448, "resize_size": 512}}
    cfg = setup_config(argv=["--config", _recipe("Baseline.yaml", run_dir, {
        "experiment": {"log_dir": run_dir}, "dataset": data,
        "model": {"num_classes": 200}, "train": {"epoch": 1, "val_first": False}})])
    if (cfg.model.name != "ResNet50" or int(cfg.dataset.batch_size) != 24
            or cfg.train.optimizer.name != "Adam"):
        raise AssertionError("configs/Baseline.yaml is no longer ResNet50, "
                             "batch 24, Adam")
    reset_launches()
    trainer = SmokeTrainer(cfg)
    bn1 = trainer.model.backbone.bn1
    before = (bn1.running_mean.clone(), bn1.running_var.clone())
    t0 = time.time()
    trainer.train()
    torch.cuda.synchronize()
    seconds = time.time() - t0
    report = trainer.last_report
    moved = not (torch.equal(bn1.running_mean, before[0])
                 or torch.equal(bn1.running_var, before[1]))
    best = os.path.join(trainer.log_root, "best_model.msgpack")  # recipe's name
    steps = trainer.step
    # the trained model's logits on the first val batch, for the Tester's
    val = trainer.device_prepare_eval(trainer.prepare_batch(
        next(iter(trainer.dataloaders["val"])), train=False))
    with torch.no_grad():
        logits = trainer.model.eval()(val["img"])["logits"]
    del trainer, bn1
    torch.cuda.empty_cache()

    test_cfg = setup_config(argv=["--config", _recipe("Baseline.yaml", run_dir, {
        "experiment": {"log_dir": run_dir}, "dataset": dict(data, length=n_val),
        "model": {"num_classes": 200, "load": best}})])
    tester = Tester(test_cfg)
    top1 = tester.test()
    with torch.no_grad():
        same_logits = torch.equal(tester.model(val["img"])["logits"], logits)
    torch.cuda.synchronize()
    launches = dict(LAUNCHES)
    del tester, val, logits
    for k in ("train_loss", "val_loss"):
        if not math.isfinite(report[k]):
            raise AssertionError(f"non-finite {k}: {report}")
    if not moved:
        raise AssertionError("bn1's running statistics did not move")
    if not same_logits:
        raise AssertionError("the Tester's model gives other logits than the "
                             "trained model on the same val batch")
    if top1 != report["val_acc"]:
        raise AssertionError(f"Tester top-1 {top1} != the Trainer's last val "
                             f"accuracy {report['val_acc']}")
    if any(launches.values()):
        raise AssertionError(f"the ResNet path launched {launches}")
    emit("slice_resnet", model="Baseline ResNet-50 448x448 200 classes, "
         "synthetic, pipeline device with ta_wide", batch=24,
         train_steps=steps, val_images=n_val, seconds_with_val=seconds,
         running_stats_moved=moved, tester_top1=top1,
         tester_logits_equal_trainer=same_logits, launches=launches,
         **report)


def run_throughput_resnet(torch, run_dir, batch=128, eval_batch=256, warmup=3,
                          timed=10):
    from hawkeye_tpu_torch.data.transforms_device import IMAGENET_MEAN, IMAGENET_STD
    from hawkeye_tpu_torch.ops import LAUNCHES, reset_launches
    from hawkeye_tpu_torch.profile_step import bench_batches, bench_trainer

    trainer = bench_trainer("resnet50", run_dir, batch)
    batches = bench_batches("resnet50", batch, timed, seed=3)
    lr = float(trainer.config.train.optimizer.lr)
    torch.cuda.reset_peak_memory_stats()
    for i in range(warmup):
        trainer.train_step_call(batches[i], lr)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    for b in batches:
        m = trainer.train_step_call(b, lr)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(LAUNCHES)
    loss = float(m["loss"])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not math.isfinite(loss):
        raise AssertionError(f"throughput step loss {loss}")
    if any(launches.values()):
        raise AssertionError(f"the ResNet step launched {launches}")
    del batches, m

    # eval: bench.py's center crop (512 -> 448 by slicing), bf16 normalise
    model = trainer.model.eval()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    raw = torch.randint(0, 256, (eval_batch, 512, 512, 3), device="cuda",
                        dtype=torch.uint8, generator=gen)
    off = (512 - 448) // 2
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.bfloat16, device="cuda")
    std = torch.tensor(IMAGENET_STD, dtype=torch.bfloat16, device="cuda")

    def eval_step(acc):
        x = raw[:, off:off + 448, off:off + 448].to(torch.bfloat16) / 255.0
        return acc + model((x - mean) / std)["logits"].argmax(-1).sum()

    acc = torch.zeros((), dtype=torch.int64, device="cuda")
    with torch.no_grad():
        for _ in range(warmup):
            acc = eval_step(acc)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(timed):
            acc = eval_step(acc)
        torch.cuda.synchronize()
        dt_eval = time.perf_counter() - t1
    emit("throughput_resnet", resnet50_train_images_per_sec=batch * timed / dt,
         resnet50_eval_images_per_sec=eval_batch * timed / dt_eval,
         batch=batch, eval_batch=eval_batch, image_size=448, dtype="bfloat16",
         warmup_steps=warmup, timed_steps=timed, ms_per_step=dt / timed * 1e3,
         eval_ms_per_step=dt_eval / timed * 1e3, last_loss=loss,
         peak_memory_gb=peak_gb, launches=launches,
         device=torch.cuda.get_device_name(0), nvidia_smi=nvidia_smi_line())
    del trainer, model, raw
    torch.cuda.empty_cache()


# ----------------------------------------------------------------------------
# phases 10-13: the high-order and webly-supervised recipes
# ----------------------------------------------------------------------------
def check_kernels_highorder(torch):
    """The three kernels at the shapes the new paths give them: the pool
    kernels on VGG-16's maps at 448x448, batch 16 (CBCNN stage 2) and at
    224x224, batch 16 (Peer-Learning, CBCNN stage 1), bit-exact; the Gram
    at x [16, 49, 512] bf16 (Peer-Learning's fused BCNN heads; K = 49 is no
    multiple of the wgmma k16 step, so the last step reads TMA's zero fill)
    within the Gram tolerances. Pool times are summed over each path's five
    shapes (one VGG-16 forward or backward)."""
    from hawkeye_tpu_torch.ops import fused_bilinear
    from hawkeye_tpu_torch.ops.bilinear import ssqrt

    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    bf16 = torch.bfloat16
    pools, pool_sums = [], {}
    for path, shapes in (("cbcnn_448_b16", CB_POOL_SHAPES),
                         ("vgg16_224_b16", PL_POOL_SHAPES)):
        rows = [dict(_pool_case(torch, shape, gen), path=path)
                for shape in shapes]
        pools += rows
        pool_sums[path] = {k: sum(r[k] for r in rows) for k in rows[0]
                           if k.endswith("_ms")}
    xg = torch.relu(torch.randn(PL_GRAM_SHAPE, device="cuda", generator=gen)).to(bf16)
    y = fused_bilinear.gram_signed_sqrt_forward(xg)
    y_ref = fused_bilinear.gram_signed_sqrt_plain(xg)
    err = (y - y_ref).abs()
    if not bool((err <= GRAM_ATOL + GRAM_RTOL * y_ref.abs()).all()):
        raise AssertionError(f"gram_signed_sqrt max err {float(err.max())} at "
                             f"{PL_GRAM_SHAPE}")
    bg, hw, c = PL_GRAM_SHAPE
    xt = xg.transpose(1, 2)
    bms, by = bound(bg * hw * c * 2 + bg * c * c * 4, 2 * bg * hw * c * c, PEAK_BF16_S)
    gram = dict(shape=list(PL_GRAM_SHAPE), max_abs_err=float(err.max()),
                ms=cuda_ms(torch, lambda: fused_bilinear.gram_signed_sqrt_forward(xg)),
                plain_ms=cuda_ms(torch, lambda: fused_bilinear.gram_signed_sqrt_plain(xg)),
                library_ms=cuda_ms(torch, lambda: ssqrt(
                    torch.bmm(xt, xg, out_dtype=torch.float32) / hw)),
                bound_ms=bms, bound_by=by)
    emit("kernels_highorder_shapes", dtype="bfloat16", pool_bit_exact=True,
         pool_sums=pool_sums, pool_shapes=pools, gram_rtol=GRAM_RTOL,
         gram_atol=GRAM_ATOL, gram=gram)


def _peer_case(torch, n_agree, seed, b=16, nc=200):
    """Two peers' logits that agree on exactly ``n_agree`` of ``b`` samples,
    with tied rows (equal logits and labels)."""
    g = torch.Generator().manual_seed(seed)
    agree = torch.randperm(b, generator=g) < n_agree
    l1 = torch.randn((b, nc), generator=g)
    l2 = torch.randn((b, nc), generator=g)
    labels = torch.randint(0, nc, (b,), generator=g)
    pred1 = l1.argmax(-1)
    l2[torch.arange(b), torch.where(agree, pred1, (pred1 + 1) % nc)] += 8.0
    for i in range(0, b - 1, 3):
        if agree[i] == agree[i + 1]:
            l1[i + 1], l2[i + 1], labels[i + 1] = l1[i], l2[i], labels[i]
    return l1, l2, labels


def check_reference_highorder(torch):
    """CBCNN and MPN on the card against the CPU, TF32 off, and both method
    losses on constructed batches."""
    import numpy as np
    import torch.nn.functional as F

    from hawkeye_tpu_torch.engine.trainer import set_tf32
    from hawkeye_tpu_torch.losses import pair_confusion, peer_learning
    from hawkeye_tpu_torch.models import init_parameters
    from hawkeye_tpu_torch.models.methods.cbcnn import CBCNN
    from hawkeye_tpu_torch.models.methods.mpn import MPN

    set_tf32(False)
    x = torch.randn((2, 64, 64, 3), generator=torch.Generator().manual_seed(7))
    y = torch.tensor([3, 7])

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    f32, f64 = torch.float32, torch.float64

    # CBCNN, VGG-16, d = 6000, one forward and backward of each precision
    def cbcnn(trunk, head, dev):
        m = CBCNN(num_classes=10, dtype=trunk)
        init_parameters(m, torch.Generator().manual_seed(8))
        m.backbone.to(trunk)
        # the pool kernels take float32 and bfloat16: a float64 trunk pools
        # with F.max_pool2d, on both devices
        m.backbone.efficient_pool = trunk != f64
        if head == f64:  # fc, sketch spectra and irDFT matrices too
            m.double()
        m.to(dev)
        logits = m(x.to(dev, trunk))["logits"]
        F.cross_entropy(logits, y.to(dev)).backward()
        return [t.detach().double().cpu() for t in (
            logits, m.backbone.features["0"].weight.grad, m.fc.weight.grad)]

    names = ("logits", "conv0_grad", "fc_grad")
    cb = {(t, h, dev): cbcnn(t, h, dev) for dev in ("cpu", "cuda")
          for t, h in ((f32, f32), (f64, f32), (f64, f64))}

    def cb_rel(a, b):
        return {n: rel(u, v) for n, u, v in zip(names, cb[a], cb[b])}

    # held: the float32 logits, and the whole model in float64; printed: the
    # float32 gradients, which the signed square root's slope at 0
    # (1/(2 sqrt(1e-10))) makes a reading of float32 rounding in the head
    # and in the trunk (a float64 trunk under the float32 head shows the
    # head's part), and the CPU's own float32 against float64
    cbcnn32 = cb_rel((f32, f32, "cuda"), (f32, f32, "cpu"))
    cbcnn64 = cb_rel((f64, f64, "cuda"), (f64, f64, "cpu"))
    cbcnn_f32_head = cb_rel((f64, f32, "cuda"), (f64, f32, "cpu"))
    cbcnn_cpu32_vs_64 = cb_rel((f32, f32, "cpu"), (f64, f64, "cpu"))
    del cb

    # MPN on ResNet-50, reduction to 256, one train-mode step
    def mpn(dtype, dev):
        m = MPN(num_classes=10, dtype=dtype)
        init_parameters(m, torch.Generator().manual_seed(9))
        m.backbone.to(dtype)  # the float32 head reads the float32 covariance
        m.dr_bn.to(dtype)
        m.to(dev).train()
        logits = m(x.to(dev, dtype))["logits"]
        F.cross_entropy(logits, y.to(dev)).backward()
        return [t.detach().double().cpu() for t in (
            logits, m.backbone.conv1.weight.grad, m.dr_conv.weight.grad,
            m.fc.weight.grad, m.dr_bn.running_var)]

    mnames = ("logits", "conv1_grad", "dr_conv_grad", "fc_grad", "dr_bn_running_var")
    cpu32, cpu64 = mpn(f32, "cpu"), mpn(f64, "cpu")
    mpn64 = {n: rel(a, b) for n, a, b in zip(mnames, mpn(f64, "cuda"), cpu64)}
    mpn32 = {n: rel(a, b) for n, a, b in zip(mnames, mpn(f32, "cuda"), cpu32)}
    cpu32_vs_64 = {n: rel(a, b) for n, a, b in zip(mnames, cpu32, cpu64)}

    # the losses: the peer masks identical and the values within 1e-6 at
    # every agreement count and every value of a T_k = 10 ramp
    ramp = np.linspace(0.0, 0.25, 10).astype(np.float32)
    loss_err = 0.0
    for n_agree in range(17):
        l1, l2, labels = _peer_case(torch, n_agree, seed=n_agree)
        for dr in ramp:
            out = {}
            for dev in ("cpu", "cuda"):
                args = [t.to(dev) for t in (l1, l2, labels)]
                k1, k2, _, _ = peer_learning.peer_keep_masks(*args, float(dr))
                v = torch.stack(peer_learning.peer_learning_losses(*args, float(dr)))
                out[dev] = (k1.cpu(), k2.cpu(), v.cpu())
            if not (torch.equal(out["cpu"][0], out["cuda"][0])
                    and torch.equal(out["cpu"][1], out["cuda"][1])):
                raise AssertionError(f"peer masks differ at {n_agree} agreeing, "
                                     f"drop rate {dr}")
            loss_err = max(loss_err, rel(out["cuda"][2], out["cpu"][2]))
        pc = [pair_confusion.PairwiseConfusionLoss({"lambda_a": 0.1})(
            {"logits": l1[:15].to(dev)}, {"label": labels[:15].to(dev)}).cpu()
            for dev in ("cpu", "cuda")]
        loss_err = max(loss_err, rel(pc[1], pc[0]))

    checks = [("cbcnn float32 logits", cbcnn32["logits"], 1e-4)]
    checks += [("cbcnn float64 " + n, cbcnn64[n], CB_F64_TOL) for n in names]
    checks += [("mpn float64 " + n, mpn64[n], 1e-4 if n in ("logits", "dr_bn_running_var")
                else 1e-2) for n in mnames]
    # float32 logits: the CPU's own float32 run is ~2e-4 of the largest logit
    # from its float64 run at this size (printed beside)
    checks += [("mpn float32 logits", mpn32["logits"], 1e-3),
               ("losses", loss_err, 1e-6)]
    for name, err, tol in checks:
        if err > tol:
            raise AssertionError(f"card vs CPU {name}: relative err {err} > {tol}")
    emit("reference_highorder", model="CBCNN vgg16 64x64 d=6000 float32; MPN "
         "resnet50 64x64 reduction 256, one train-mode step; TF32 off",
         cbcnn_float32_rel_err_of_max=cbcnn32,
         cbcnn_float64_rel_err_of_max=cbcnn64,
         cbcnn_float64_trunk_float32_head_rel_err_of_max=cbcnn_f32_head,
         cbcnn_cpu_float32_vs_float64=cbcnn_cpu32_vs_64,
         mpn_float64_rel_err_of_max=mpn64,
         mpn_float32_rel_err_of_max=mpn32,
         mpn_cpu_float32_vs_float64=cpu32_vs_64, loss_rel_err=loss_err,
         peer_masks_identical=True,
         tolerances={n: t for n, _, t in checks})


def _train_stage(torch, trainer_cls, config, run_dir, overrides, want=None,
                 loads=None, prepare=None):
    """One recipe stage through an Example trainer, launch counts set to 0
    before and read after; ``want`` the exact counts it must give, ``loads``
    the state dict that ``model.load`` must have put in the model,
    ``prepare`` a function called with the trainer before it trains."""
    from hawkeye_tpu_torch.config import setup_config
    from hawkeye_tpu_torch.ops import LAUNCHES, reset_launches

    cfg = setup_config(argv=["--config", _recipe(config, run_dir, overrides)])
    reset_launches()
    trainer = type(trainer_cls.__name__, (_Recorder, trainer_cls), {})(cfg)
    own = trainer.model.state_dict()
    if loads is not None and (own.keys() != loads.keys() or not all(
            torch.equal(own[k].cpu(), v) for k, v in loads.items())):
        raise AssertionError(f"{config}: model.load did not load stage 1's weights")
    if prepare is not None:
        prepare(trainer)
    t0 = time.time()
    trainer.train()
    torch.cuda.synchronize()
    seconds = time.time() - t0
    launches = dict(LAUNCHES)
    rep = trainer.last_report
    for k in ("train_loss", "val_loss"):
        if not math.isfinite(rep[k]):
            raise AssertionError(f"{config}: non-finite {k}: {rep}")
    if want is not None and launches != want:
        raise AssertionError(f"{config}: launches {launches}, expected {want}")
    return trainer, dict(rep, launches=launches, train_steps=trainer.step,
                         seconds_with_val=seconds)


ZERO_LAUNCHES = {"pool_fwd": 0, "pool_bwd": 0, "gram_signed_sqrt": 0}


def _tester_matches(torch, trainer, config, run_dir, over, want_top1=None,
                    want_launches=ZERO_LAUNCHES):
    """The Tester on the trainer's best model and val split: its top-1 must
    be the trainer's best val accuracy (or ``want_top1``, where the
    trainer's validation calls the model otherwise than the Tester), and its
    logits on the first val batch the trained model's in memory, so that the
    hold covers save and load. Only where an earlier epoch than the last was
    the best (the trainer saves the last of equal bests) does the trainer's
    model first load the saved best. Launches must be ``want_launches`` (0
    unless the model runs the kernels)."""
    from hawkeye_tpu_torch.config import setup_config
    from hawkeye_tpu_torch.engine import Tester
    from hawkeye_tpu_torch.engine import checkpoint as ckpt
    from hawkeye_tpu_torch.ops import LAUNCHES, reset_launches

    best = os.path.join(trainer.log_root, "best_model.msgpack")  # the recipe's name
    meter = trainer.performance_meters["val"]["acc"]
    val_acc = meter.best_value
    if meter.values[-1] != val_acc:
        ckpt.load_model(best, trainer.model)
    if want_top1 is not None:
        val_acc = want_top1
    val = trainer.prepare_batch(next(iter(trainer.dataloaders["val"])), train=False)
    if trainer.pipeline == "device":
        val = trainer.device_prepare_eval(val)
    with torch.no_grad():
        logits = trainer.model.eval()(val["img"])["logits"]
    n_val = len(trainer.datasets["val"])
    reset_launches()
    tester = Tester(setup_config(argv=["--config", _recipe(config, run_dir, {
        **over, "dataset": dict(over["dataset"], length=n_val),
        "model": dict(over["model"], load=best)})]))
    top1 = tester.test()
    with torch.no_grad():
        same = torch.equal(tester.model(val["img"])["logits"], logits)
    torch.cuda.synchronize()
    if not same or top1 != val_acc or dict(LAUNCHES) != want_launches:
        raise AssertionError(f"{config} Tester: logits equal {same}, top-1 {top1} "
                             f"vs the Trainer's {val_acc}, launches {dict(LAUNCHES)}")
    return top1


def _emit_rate(torch, recipe, rate, want, phase="throughput_highorder", **fields):
    if rate["launches_per_step"] != want:
        raise AssertionError(f"{recipe}: launches per step "
                             f"{rate['launches_per_step']}, expected {want}")
    emit(phase, recipe=recipe,
         **{f"{recipe}_train_images_per_sec": rate.pop("images_per_sec")},
         **rate, **fields, dtype="bfloat16 trunk, float32 head",
         device=torch.cuda.get_device_name(0), nvidia_smi=nvidia_smi_line())


def _inverse_transform_ms(torch, model, batch):
    """The CBCNN head's inverse transform at the recipe's shape, both ways:
    the irDFT matmuls the port runs (as the JAX package does) and
    ``torch.fft.irfft``, on the same spectra; device times and their
    difference relative to the largest value."""
    from hawkeye_tpu_torch.ops.cbp import _irdft_apply

    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    k, d = model.irdft_cos.shape[0], model.output_channel
    sr, si = (torch.randn((batch, k), device="cuda", generator=gen) for _ in range(2))
    irdft = (model.irdft_cos, model.irdft_sin)
    a = _irdft_apply(sr, si, irdft)
    b = torch.fft.irfft(torch.complex(sr, si), n=d, dim=-1)
    return {"irdft_ms": cuda_ms(torch, lambda: _irdft_apply(sr, si, irdft)),
            "irfft_ms": cuda_ms(torch, lambda: torch.fft.irfft(
                torch.complex(sr, si), n=d, dim=-1)),
            "irfft_vs_irdft_rel_err": float((a - b).abs().max() / b.abs().max())}


def run_highorder(torch, run_dir, n_train=32):
    """slice_highorder and throughput_highorder: CBCNN S1 -> S2 and the
    Tester, MPN, Peer-Learning S1 -> S2 and Pairwise Confusion, each
    through its Example trainer at its recipe's shape (synthetic data, 200
    classes, one epoch of ``n_train`` images, a quarter of that for val),
    each followed by its train rate. Returns the kernels' launches summed
    over the stages."""
    from hawkeye_tpu_torch.config import setup_config
    from hawkeye_tpu_torch.engine import Tester
    from hawkeye_tpu_torch.examples.CBCNN import CBCNNTrainer
    from hawkeye_tpu_torch.examples.MPN import MPNTrainer
    from hawkeye_tpu_torch.examples.PairConfusion import PairConfusionTrainer
    from hawkeye_tpu_torch.examples.PeerLearning import PLTrainer
    from hawkeye_tpu_torch.profile_step import bench_trainer

    n_val = n_train // 4
    common = {"experiment": {"log_dir": run_dir},
              "dataset": {"name": "synthetic", "length": n_train,
                          "num_workers": 8, "num_classes": 200},
              "model": {"num_classes": 200}, "train": {"epoch": 1}}
    total = {"pool_fwd": 0, "pool_bwd": 0, "gram_signed_sqrt": 0}

    def counts(vgg_trunks, forwards, steps, grams=0):
        return {"pool_fwd": 5 * vgg_trunks * forwards,
                "pool_bwd": 5 * vgg_trunks * steps,
                "gram_signed_sqrt": grams}

    def per_step(vgg_trunks, grams):
        return {"pool_fwd": 5.0 * vgg_trunks, "pool_bwd": 5.0 * vgg_trunks,
                "gram_signed_sqrt": float(grams)}

    def add(launches):
        for k in total:
            total[k] += launches[k]

    def rate(model, batch, want, **fields):
        """The recipe's train rate: ``profile_step``'s benchmark trainer and
        batches for ``model``, the step that ``profile_step`` profiles."""
        trainer = bench_trainer(model, run_dir, batch)
        r = _train_rate(torch, trainer, model, batch)
        if model == "cbcnn":
            fields.update(_inverse_transform_ms(torch, trainer.model, batch))
        del trainer
        torch.cuda.empty_cache()
        _emit_rate(torch, model, r, want, **fields)

    # CBCNN: stage 1 at its recipe's 224x224, stage 2 at 448x448, batch 16
    b = 16
    steps, val_batches = n_train // b, -(-n_val // b)
    s1, r1 = _train_stage(torch, CBCNNTrainer, "CBCNN_S1.yaml", run_dir, common,
                          counts(1, steps + val_batches, 0))
    best1 = os.path.join(s1.log_root, "best_model.msgpack")  # the recipe's name
    s1_state = {k: v.detach().cpu().clone() for k, v in s1.model.state_dict().items()}
    del s1
    s2_over = dict(common, model={"num_classes": 200, "load": best1})
    s2, r2 = _train_stage(torch, CBCNNTrainer, "CBCNN_S2.yaml", run_dir, s2_over,
                          counts(1, steps + 2 * val_batches, steps),
                          loads=s1_state)
    add(r1["launches"])
    add(r2["launches"])
    cfg2 = s2.config
    if (cfg2.model.name != "CBCNN" or int(cfg2.dataset.batch_size) != b
            or int(cfg2.dataset.transformer.image_size) != 448
            or int(cfg2.model.output_channel) != 6000):
        raise AssertionError("configs/CBCNN_S2.yaml is no longer CBCNN d=6000 "
                             "at 448x448, batch 16")
    best2 = os.path.join(s2.log_root, "best_model.msgpack")
    val = s2.prepare_batch(next(iter(s2.dataloaders["val"])), train=False)
    with torch.no_grad():
        logits = s2.model.eval()(val["img"])["logits"]
    tester = Tester(setup_config(argv=["--config", _recipe("CBCNN_S2.yaml", run_dir, {
        "experiment": {"log_dir": run_dir},
        "dataset": dict(common["dataset"], length=n_val),
        "model": {"num_classes": 200, "load": best2}})]))
    top1 = tester.test()
    with torch.no_grad():
        same_logits = torch.equal(tester.model(val["img"])["logits"], logits)
    if not same_logits or top1 != r2["val_acc"]:
        raise AssertionError(f"CBCNN Tester: logits equal {same_logits}, top-1 "
                             f"{top1} vs the Trainer's {r2['val_acc']}")
    del tester, val, logits, s2
    torch.cuda.empty_cache()
    emit("slice_highorder", recipe="cbcnn", model="CBCNN vgg16 d=6000, 200 "
         "classes, synthetic", batch=b, stage1=dict(r1, image_size=224),
         stage2=dict(r2, image_size=448), tester_top1=top1,
         tester_logits_equal_trainer=same_logits)
    rate("cbcnn", b, per_step(1, 0), stage=2)

    # MPN: ResNet-50, 224x224, batch 8, backbone at 0.2x the LR
    mpn, rm = _train_stage(torch, MPNTrainer, "MPN.yaml", run_dir, common,
                           counts(0, 0, 0))
    groups = {g["label"]: g for g in mpn.optimizer.param_groups}
    lr_ratio = groups["backbone"]["lr"] / groups["head"]["lr"]
    n_backbone = len(list(mpn.model.backbone.parameters()))
    if (abs(lr_ratio - 0.2) > 1e-12 or len(groups["backbone"]["params"]) != n_backbone
            or groups["head"]["lr"] != mpn.scheduler.current_lr):
        raise AssertionError(f"MPN groups: ratio {lr_ratio}, backbone params "
                             f"{len(groups['backbone']['params'])} of {n_backbone}")
    add(rm["launches"])
    mpn_batch = int(mpn.config.dataset.batch_size)
    emit("slice_highorder", recipe="mpn", model="MPN resnet50 reduction 256, "
         "200 classes, synthetic", batch=mpn_batch,
         image_size=224, lr_backbone=groups["backbone"]["lr"],
         lr_head=groups["head"]["lr"], lr_ratio=lr_ratio, **rm)
    del mpn, groups
    torch.cuda.empty_cache()
    rate("mpn", mpn_batch, per_step(0, 0))

    # Peer-Learning: two BCNN VGG-16 peers, 224x224, batch 16
    p1, rp1 = _train_stage(torch, PLTrainer, "PeerLearning_BCNN_S1.yaml", run_dir,
                           common, counts(2, steps + val_batches, 0))
    best_p1 = os.path.join(p1.log_root, "best_model.msgpack")
    p1_state = {k: v.detach().cpu().clone() for k, v in p1.model.state_dict().items()}
    del p1
    p2_over = dict(common, model={"num_classes": 200, "load": best_p1,
                                  "base_model": {"fused_pooling": True}})
    forwards = steps + 2 * val_batches
    p2, rp2 = _train_stage(torch, PLTrainer, "PeerLearning_BCNN_S2.yaml", run_dir,
                           p2_over, counts(2, forwards, steps, grams=2 * forwards),
                           loads=p1_state)
    acc = {k: p2.performance_meters["train"][k].values for k in ("acc1", "acc2")}
    if not all(acc.values()):
        raise AssertionError(f"Peer-Learning meters not filled: {acc}")
    add(rp1["launches"])
    add(rp2["launches"])
    del p2
    torch.cuda.empty_cache()
    emit("slice_highorder", recipe="peer_learning", model="PeerLearningNet, two "
         "BCNN vgg16 peers, 200 classes, synthetic", batch=b, image_size=224,
         stage1=rp1, stage2=dict(rp2, fused_pooling=True, acc1=acc["acc1"],
                                 acc2=acc["acc2"]))
    rate("peer_learning", b, per_step(2, 2), stage=2, fused_pooling=True)

    # Pairwise Confusion: Baseline ResNet-50, 224x224, batch 24
    pc, rpc = _train_stage(torch, PairConfusionTrainer, "PC_resnet50.yaml", run_dir,
                           common, counts(0, 0, 0))
    add(rpc["launches"])
    pc_batch = int(pc.config.dataset.batch_size)
    emit("slice_highorder", recipe="pair_confusion", model="Baseline ResNet-50 "
         "with PairwiseConfusionLoss (lambda 0.1), 200 classes, synthetic",
         batch=pc_batch, image_size=224, **rpc)
    del pc
    torch.cuda.empty_cache()
    rate("pair_confusion", pc_batch, per_step(0, 0))
    return total


# ----------------------------------------------------------------------------
# phases 14-16: the fourth slice, OSME + MAMC, API-Net, CIN, CrossX and
# Interp-Parts through their Example trainers
# ----------------------------------------------------------------------------
# recipe -> (config, Example module, trainer class, input size, batch)
PAIR_RECIPES = {"osme": ("OSMENet.yaml", "OSMENet", "OSMETrainer", 224, 10),
                "apinet": ("APINet.yaml", "APINet", "APINetTrainer", 224, 40),
                "cin": ("CIN.yaml", "CIN", "CINTrainer", 224, 20),
                "crossx": ("CrossX.yaml", "CrossX", "CrossXTrainer", 448, 8),
                "interp_parts": ("InterpPartsNet.yaml", "InterpPartsNet",
                                 "InterpPartsTrainer", 448, 16)}
# card against CPU, relative to each tensor's largest value: the whole model
# in float64 (held), float32 logits (held; gradients printed). Interp-Parts'
# float32 logits come through groupingbn, a BatchNorm over the batch of 4.
PAIR_F64_TOL = 1e-6
PAIR_F32_LOGITS_TOL = {"osme": 1e-3, "apinet": 1e-3, "cin": 1e-3, "crossx": 1e-3,
                       "interp_parts": 1e-2}
# gradients that are 0 in exact arithmetic (a bias right before a BatchNorm
# over its one channel): held below 1e-6 of the model's largest gradient
PAIR_ZERO_GRADS = {"interp_parts": ("attconv_out.bias",)}


def _soften(torch, model):
    """Soft Interp-Parts assignments: the last trunk block's BatchNorm
    outputs at 0.05x and the part centres from N(0, 0.1^2). At the init's
    scale the assignments are one-hot, and the shaping loss sits at the kink
    of its absolute value, where rounding picks its gradient's sign."""
    last = getattr(model.backbone, model.backbone.stage_names[-1][-1])
    with torch.no_grad():
        for bn in (last.bn3, last.downsample_bn if last.downsample else None):
            if bn is not None:
                bn.weight.mul_(0.05)
                bn.bias.mul_(0.05)
        model.grouping.weight.normal_(0.0, 0.1, generator=torch.Generator().manual_seed(3))


def _pair_case(torch, name, dtype, dev):
    """One train-mode forward and backward of ``name``'s model (small input,
    the recipe's trunk and loss, BatchNorm scales and biases at random) on
    ``dev``: (logits, {parameter: gradient}, extra outputs)."""
    from hawkeye_tpu_torch.losses.apinet import APINetLoss
    from hawkeye_tpu_torch.losses.cin import CINLoss
    from hawkeye_tpu_torch.losses.crossx import CrossXLoss
    from hawkeye_tpu_torch.losses.interp_parts import InterpPartsLoss
    from hawkeye_tpu_torch.losses.mamc import MAMCLoss
    from hawkeye_tpu_torch.models import init_parameters
    from hawkeye_tpu_torch.models.backbones.norm import BatchNorm
    from hawkeye_tpu_torch.models.methods import apinet, cin, crossx, interp_parts, osme

    size, labels = 64, [3, 3, 7, 7]
    if name == "osme":
        m = osme.OSMENet(200, backbone_name="resnet101", image_size=size, dtype=dtype)
        crit = MAMCLoss({"lambda_a": 0.5})
    elif name == "apinet":  # dropout off: the two devices draw other masks
        m = apinet.APINet(200, "resnet101", dropout_rate=0.0, dtype=dtype)
        crit, labels = APINetLoss(), [1, 1, 5, 5, 9, 9]
    elif name == "cin":
        m = cin.CIN(200, "resnet50", image_size=size, dtype=dtype)
        crit, labels = CINLoss({"alpha": 2.0, "beta": 0.5}), [2, 5, 2, 8]
    elif name == "crossx":
        m = crossx.CrossXNet(200, 2, dtype=dtype)
        crit, labels = CrossXLoss({"num_parts": 2, "gamma": [0.5, 0.25, 0.5]}), [4, 9]
    else:
        m = interp_parts.InterpParts(200, 5, (3, 4, 23), dtype=dtype)
        crit, labels, size = InterpPartsLoss({"radius": 2, "std": 0.4, "alpha": 1,
                                              "beta": 0.001, "coeff": 0.5}), \
            [0, 1, 2, 3], 96
    gen = torch.Generator().manual_seed(11)
    init_parameters(m, gen)
    with torch.no_grad():
        for mod in m.modules():
            if isinstance(mod, BatchNorm):
                mod.weight.copy_(1 + 0.3 * torch.randn(mod.weight.shape, generator=gen))
                mod.bias.copy_(0.1 * torch.randn(mod.bias.shape, generator=gen))
    if name == "interp_parts":
        _soften(torch, m)
    if dtype == torch.float64:
        m.double()
    m.to(dev).train()
    y = torch.tensor(labels, device=dev)
    x = torch.randn((len(labels), size, size, 3), generator=torch.Generator().manual_seed(12))
    x = x.to(dev, dtype)
    out = m(x, labels=y) if name == "apinet" else m(x)
    crit(out, {"label": y}).backward()
    grads = {n: p.grad.detach().double().cpu() for n, p in m.named_parameters()}
    extra = {}
    if name == "apinet":  # the mined partners, and how near their runners-up
        with torch.no_grad():
            pool = m.backbone(x)["c5"].mean(dim=(1, 2)).to(m.fc.weight.dtype)
            intra, inter = apinet.mine_pairs(pool, y)
            sq = (pool ** 2).sum(1)
            d = (sq[:, None] + sq[None, :] - 2 * pool @ pool.T).double().cpu()
        same = y.cpu()[:, None] == y.cpu()[None, :]
        inter_d = d.masked_fill(same, float("inf")).sort(dim=1).values[:, :2]
        # the smallest relative margin of a mined inter-class partner over
        # the runner-up (the intra search has one candidate at K = 2)
        extra = {"intra": intra.cpu(), "inter": inter.cpu(), "inter_gap": float(
            ((inter_d[:, 1] - inter_d[:, 0]) / inter_d[:, 1]).min())}
    return out["logits"].detach().double().cpu(), grads, extra


def check_reference_pairs(torch):
    """The five models on the card against the CPU, TF32 off."""
    from hawkeye_tpu_torch.engine.trainer import set_tf32

    set_tf32(False)

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))

    report = {}
    for name in PAIR_RECIPES:
        row = {}
        for label, dtype in (("float64", torch.float64), ("float32", torch.float32)):
            (lc, gc, ec), (lg, gg, eg) = (_pair_case(torch, name, dtype, dev)
                                          for dev in ("cpu", "cuda"))
            zero = PAIR_ZERO_GRADS.get(name, ())
            errs = {n: rel(gg[n], gc[n]) for n in gc if n not in zero}
            worst = max(errs, key=errs.get)
            top = max(float(g.abs().max()) for g in (*gc.values(), *gg.values()))
            row[label] = {"logits": rel(lg, lc), "grad_max": errs[worst],
                          "grad_worst": worst,
                          "zero_grads_of_max": max((float(g[n].abs().max()) / top
                                                    for g in (gc, gg) for n in zero),
                                                   default=0.0)}
            if ec:
                row[label]["pairs_equal"] = bool(torch.equal(ec["intra"], eg["intra"])
                                                 and torch.equal(ec["inter"], eg["inter"]))
                row[label]["inter_gap"] = ec["inter_gap"]
        report[name] = row
        f64 = row["float64"]
        if (f64["logits"] > PAIR_F64_TOL or f64["grad_max"] > PAIR_F64_TOL
                or f64["zero_grads_of_max"] > 1e-6
                or row["float32"]["logits"] > PAIR_F32_LOGITS_TOL[name]
                or not f64.get("pairs_equal", True)):
            raise AssertionError(f"card vs CPU {name}: {row}")
    emit("reference_pairs", model="OSME resnet101 64x64 b4, API-Net resnet101 "
         "64x64 b6 (dropout off), CIN resnet50 64x64 b4, CrossX 64x64 b2, "
         "IP-ResNet-101 96x96 b4 K=5 (soft assignments); one train-mode step "
         "through each method's loss, BatchNorm at random; TF32 off",
         rel_err_of_max=report, tolerances={"float64": PAIR_F64_TOL,
                                            "float32_logits": PAIR_F32_LOGITS_TOL,
                                            "zero_grads": PAIR_ZERO_GRADS})


def _pair_overrides(name, run_dir, n_steps=4):
    """Synthetic data for ``n_steps`` full train batches of the recipe at its
    shapes: a P x K recipe draws its labels from P classes, each with ~4x
    its K images, so that every batch is full (``bench_methods.py`` sizes
    its set for the same reason)."""
    config, _, _, size, batch = PAIR_RECIPES[name]
    ds = {"name": "synthetic", "length": n_steps * batch, "num_workers": 8,
          "num_classes": 200}
    with open(os.path.join(ROOT, "configs", config)) as f:
        import yaml

        recipe = yaml.safe_load(f)["dataset"]
    if "n_samples" in recipe:
        ds["num_classes"] = int(recipe["n_classes"])
    return {"experiment": {"log_dir": run_dir}, "dataset": ds,
            "model": {"num_classes": 200}, "train": {"epoch": 1}}


def run_pairs(torch, run_dir):
    """slice_pairs and throughput_pairs: each of the five recipes through
    its Example trainer at its recipe's shape, then the Tester on its best
    model, then its train rate on ``profile_step``'s trainer. Every kernel's
    launch count must stay 0 on these paths."""
    import importlib

    from hawkeye_tpu_torch.profile_step import bench_trainer

    for name, (config, module, cls, size, batch) in PAIR_RECIPES.items():
        trainer_cls = getattr(importlib.import_module(
            f"hawkeye_tpu_torch.examples.{module}"), cls)
        over = _pair_overrides(name, run_dir)
        tr, rep = _train_stage(torch, trainer_cls, config, run_dir, over, ZERO_LAUNCHES)
        cfg = tr.config
        sampler = tr.dataloaders["train"].batch_sampler
        sizes = {len(b) for b in sampler}
        if (int(cfg.dataset.transformer.image_size) != size or sizes != {batch}
                or tr.step != len(sampler)):
            raise AssertionError(f"{config}: image size "
                                 f"{cfg.dataset.transformer.image_size}, batch sizes "
                                 f"{sizes}, {tr.step} steps, not {size}px batch {batch}")
        fields = {}
        if name == "interp_parts":
            groups = {g["label"]: g["lr"] for g in tr.optimizer.param_groups}
            if abs(groups["scratch"] / groups["finetune"] - 20.0) > 1e-9:
                raise AssertionError(f"Interp-Parts group LRs {groups}")
            fields["group_lrs"] = groups
        top1 = _tester_matches(torch, tr, config, run_dir, over)
        del tr
        torch.cuda.empty_cache()
        emit("slice_pairs", recipe=name, config=config, batch=batch, image_size=size,
             tester_top1=top1, tester_logits_equal_trainer=True,
             tester_launches=ZERO_LAUNCHES, **fields, **rep)

        trainer = bench_trainer(name, run_dir, batch)
        r = _train_rate(torch, trainer, name, batch)
        del trainer
        torch.cuda.empty_cache()
        _emit_rate(torch, name, r, {k: 0.0 for k in ZERO_LAUNCHES},
                   phase="throughput_pairs")


# ----------------------------------------------------------------------------
# phases 17-19: the fifth slice, ProtoTree and DCL through their Example
# trainers
# ----------------------------------------------------------------------------
# card against CPU, relative to each tensor's largest value: the whole model
# in float64 (logits and gradients; the leaf update absolutely), float32
# logits (held; gradients printed)
TREE_F64_TOL, TREE_LEAF_TOL, TREE_F32_LOGITS_TOL = 1e-6, 1e-10, 1e-3


def _bn_at_random(torch, model, gen):
    from hawkeye_tpu_torch.models.backbones.norm import BatchNorm

    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, BatchNorm):
                mod.weight.copy_(1 + 0.3 * torch.randn(mod.weight.shape, generator=gen))
                mod.bias.copy_(0.1 * torch.randn(mod.bias.shape, generator=gen))


def _tree_model(torch, dtype, protos=None):
    """ProtoTree on ResNet-50 at the recipe's height 9 and D = 256, 200
    classes, seeded, on the CPU: BatchNorm scales and biases and the leaves
    at random, the prototypes ``protos``."""
    from hawkeye_tpu_torch.models import init_parameters
    from hawkeye_tpu_torch.models.methods.prototree import ProtoTreeNet

    m = ProtoTreeNet(200, height=9, num_features=256, backbone_name="resnet50",
                     dtype=dtype)
    gen = torch.Generator().manual_seed(21)
    init_parameters(m, gen)
    _bn_at_random(torch, m, gen)
    with torch.no_grad():
        m.dist_params.copy_(torch.randn(m.dist_params.shape, generator=gen))
        if protos is not None:
            m.prototypes.copy_(protos)
    return m.double() if dtype == torch.float64 else m


def _tree_prototypes(torch, x):
    """Prototypes near the train-mode features of ``x`` (computed once, on
    the CPU in float64): prototype i is position i % 16 of the 4 images'
    2x2 feature maps plus N(0, 0.03^2), a distance of about 16 x 0.03 = 0.48
    over D = 256, so that its branch goes right for its own image and left
    for the others."""
    import torch.nn.functional as F

    m = _tree_model(torch, torch.float64).train()
    with torch.no_grad():
        w = m.neck_conv.weight
        feats = torch.sigmoid(F.linear(m.backbone(x.double())["c5"], w.flatten(1)))
    feats = feats.reshape(-1, 256).float()
    noise = torch.randn((511, 256), generator=torch.Generator().manual_seed(22))
    return feats[torch.arange(511) % feats.shape[0]] + 0.03 * noise


def _tree_case(torch, dtype, dev, x, protos):
    """One train-mode step of ProtoTree through ProtoTreeLoss, the leaf
    update on its outputs, and the sample_max and greedy leaves (the leaf
    whose distribution each row's prediction is) of a train-mode forward,
    whose features the prototypes were drawn near."""
    from hawkeye_tpu_torch.losses.prototree import ProtoTreeLoss, leaf_update
    from hawkeye_tpu_torch.models.methods.prototree import l2_distances

    m = _tree_model(torch, dtype, protos).to(dev).train()
    y = torch.tensor([3, 77, 150, 3], device=dev)
    xd = x.to(dev, dtype)
    out = m(xd)
    ProtoTreeLoss()(out, {"label": y}).backward()
    grads = {n: p.grad.detach().double().cpu() for n, p in m.named_parameters()}
    old = torch.rand(m.dist_params.shape, generator=torch.Generator().manual_seed(23))
    with torch.no_grad():
        leaves = leaf_update(m.dist_params, old.to(dev, m.dist_params.dtype),
                             out["pa_leaf"], out["leaf_dist"], out["pred"], y, 200)
        picked = {}
        for s in ("sample_max", "greedy"):
            e = m(xd, sampling=s)
            picked[s] = (e["pred"][:, None, :] - e["leaf_dist"][None]).abs().sum(
                -1).argmin(dim=1).cpu()
        w = m.neck_conv.weight
        feats = torch.sigmoid(torch.nn.functional.linear(
            m.backbone(xd)["c5"].to(w.dtype), w.flatten(1)))
        above = float((torch.exp(-l2_distances(feats, m.prototypes)) > 0.5).float().mean())
    return (out["logits"].detach().double().cpu(), grads,
            {"leaves": leaves.double().cpu(), "picked": picked, "above_half": above})


def _dcl_case(torch, dtype, dev, batch):
    """One train-mode step of DCL (ResNet-50) through DCLLoss."""
    from hawkeye_tpu_torch.losses.dcl import DCLLoss
    from hawkeye_tpu_torch.models import init_parameters
    from hawkeye_tpu_torch.models.methods.dcl import DCL

    m = DCL(200, backbone_name="resnet50", dtype=dtype)
    gen = torch.Generator().manual_seed(24)
    init_parameters(m, gen)
    _bn_at_random(torch, m, gen)
    if dtype == torch.float64:
        m.double()
    m.to(dev).train()
    b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    b["img"] = b["img"].to(dtype)
    out = m(b["img"])
    DCLLoss({"alpha": 1, "beta": 1, "gamma": 1})(out, b).backward()
    grads = {n: p.grad.detach().double().cpu() for n, p in m.named_parameters()}
    return out["logits"].detach().double().cpu(), grads, {}


def check_reference_tree_dcl(torch):
    """ProtoTree (ResNet-50, 64x64, batch 4, height 9, D = 256) and DCL
    (ResNet-50, 128x128: a 4x4 c5, a 2x2 mask and a 4-cell law; 2 images,
    so 4 rows of its host collate with a 2x2 jigsaw) on the card against the
    CPU, one train-mode step each, TF32 off."""
    import numpy as np

    from hawkeye_tpu_torch.data.dcl import DCLTrainCollate
    from hawkeye_tpu_torch.engine.trainer import set_tf32

    set_tf32(False)

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))

    x = torch.randn((4, 64, 64, 3), generator=torch.Generator().manual_seed(25))
    protos = _tree_prototypes(torch, x)
    rs = np.random.RandomState(26)
    items = [{"img": rs.randint(0, 256, (128, 128, 3)).astype(np.uint8),
              "label": int(rs.randint(0, 200))} for _ in range(2)]
    dcl_batch = DCLTrainCollate(grid=2, cls_2=True, seed=27)(items)
    cases = {"prototree": lambda dtype, dev: _tree_case(torch, dtype, dev, x, protos),
             "dcl": lambda dtype, dev: _dcl_case(torch, dtype, dev, dcl_batch)}
    report = {}
    for name, case in cases.items():
        row = {}
        for label, dtype in (("float64", torch.float64), ("float32", torch.float32)):
            (lc, gc, ec), (lg, gg, eg) = (case(dtype, dev) for dev in ("cpu", "cuda"))
            errs = {n: rel(gg[n], gc[n]) for n in gc}
            worst = max(errs, key=errs.get)
            row[label] = {"logits": rel(lg, lc), "grad_max": errs[worst],
                          "grad_worst": worst}
            if ec:
                row[label].update(
                    leaf_update_max_abs=float((eg["leaves"] - ec["leaves"]).abs().max()),
                    leaves_identical={s: bool(torch.equal(eg["picked"][s], ec["picked"][s]))
                                      for s in ec["picked"]},
                    greedy_leaves=ec["picked"]["greedy"].tolist(),
                    sample_max_leaves=ec["picked"]["sample_max"].tolist(),
                    branch_probs_above_half=ec["above_half"])
        report[name] = row
        f64 = row["float64"]
        if (f64["logits"] > TREE_F64_TOL or f64["grad_max"] > TREE_F64_TOL
                or row["float32"]["logits"] > TREE_F32_LOGITS_TOL
                or f64.get("leaf_update_max_abs", 0.0) > TREE_LEAF_TOL
                or not all(f64.get("leaves_identical", {}).values())):
            raise AssertionError(f"card vs CPU {name}: {row}")
    emit("reference_tree_dcl", model="ProtoTree resnet50 64x64 b4 height 9 D=256 "
         "(prototypes near the features, leaves at random); DCL resnet50 128x128, "
         "2 images -> 4 rows (2x2 jigsaw); one train-mode step through each "
         "method's loss, BatchNorm at random; TF32 off",
         rel_err_of_max=report,
         tolerances={"float64": TREE_F64_TOL, "float64_leaf_update_abs": TREE_LEAF_TOL,
                     "float32_logits": TREE_F32_LOGITS_TOL})


def _torchvision_resnet50(torch, seed):
    """A seeded ResNet-50 state dict under torchvision's names (what a
    ``.pth`` of ImageNet weights holds): convolutions at He scale,
    BatchNorm near the identity, ``num_batches_tracked`` and a 1000-way
    ``fc``."""
    import re

    from hawkeye_tpu_torch.models.backbones.resnet import BACKBONE

    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in BACKBONE.get("resnet50")(num_classes=0).state_dict().items():
        k = re.sub(r"^layer(\d+)_(\d+)\.", r"layer\1.\2.", k)
        k = k.replace("downsample_conv", "downsample.0").replace("downsample_bn",
                                                                 "downsample.1")
        n = torch.randn(v.shape, generator=gen)
        if v.dim() == 4:
            sd[k] = n * math.sqrt(2.0 / v[0].numel())
        elif k.endswith("running_var"):
            sd[k] = 1 + 0.1 * n.abs()
            sd[k.replace("running_var", "num_batches_tracked")] = torch.tensor(100)
        else:
            sd[k] = (1.0 if k.endswith("weight") else 0.0) + 0.1 * n
    sd["fc.weight"] = 0.01 * torch.randn((1000, 2048), generator=gen)
    sd["fc.bias"] = torch.zeros(1000)
    return sd


def run_tree_dcl(torch, run_dir):
    """slice_tree_dcl and throughput_tree_dcl: ProtoTree and DCL through
    their Example trainers at their recipes' shapes, the Tester, then their
    train rates. Every kernel's launch count must stay 0."""
    from hawkeye_tpu_torch.examples.DCL import DCLTrainer
    from hawkeye_tpu_torch.examples.ProtoTreeNet import ProtoTreeTrainer
    from hawkeye_tpu_torch.models.methods.prototree import load_tree, save_tree
    from hawkeye_tpu_torch.profile_step import bench_trainer

    # ProtoTree: configs/ProtoTreeNet.yaml, ResNet-50 224x224, batch 64,
    # height 9, D = 256, AdamW, warm-up cosine; a pretrained .pth; two
    # epochs of two steps with the backbone's gate at epoch 1
    pth = os.path.join(run_dir, "resnet50_imagenet.pth")
    sd = _torchvision_resnet50(torch, 28)
    torch.save(sd, pth)
    n_loaded = sum(1 for k in sd if "num_batches" not in k and not k.startswith("fc."))
    tree_over = {"experiment": {"log_dir": run_dir},
                 "dataset": {"name": "synthetic", "length": 128, "num_workers": 8,
                             "num_classes": 200},
                 "model": {"num_classes": 200,
                           "backbone": {"name": "resnet50", "pretrain": pth}},
                 "train": {"epoch": 2}}
    snaps, reports = [], []

    def prepare(tr):
        tr.FREEZE_EPOCHS = 1
        own = tr.model.backbone.state_dict()
        if own["layer4_2.conv3.weight"].cpu().ne(sd["layer4.2.conv3.weight"]).any():
            raise AssertionError("the pretrained backbone was not loaded")

        def snapshot():
            snaps.append(({n: p.detach().cpu().clone()
                           for n, p in tr.model.backbone.named_parameters()},
                          tr.model.dist_params.cpu().clone()))

        snapshot()
        tr.on_end_epoch = snapshot
        report = tr.report

        def keep(*args):
            report(*args)
            reports.append(dict(tr.last_report))

        tr.report = keep

    tree, rep = _train_stage(torch, ProtoTreeTrainer, "ProtoTreeNet.yaml", run_dir,
                             tree_over, ZERO_LAUNCHES, prepare=prepare)
    cfg = tree.config
    if (int(cfg.dataset.batch_size) != 64 or int(cfg.dataset.transformer.image_size) != 224
            or int(cfg.model.height) != 9 or int(cfg.model.num_features) != 256
            or cfg.train.optimizer.name != "AdamW" or tree.step != 4):
        raise AssertionError("configs/ProtoTreeNet.yaml is no longer ResNet-50 224x224 "
                             f"b64 height 9 D 256 AdamW ({tree.step} steps)")
    with open(os.path.join(tree.log_root, "report.log")) as f:
        log = f.read()
    if f"partial load: {n_loaded} tensors loaded, 2 missing" not in log:
        raise AssertionError(f"the log shows no load of the {n_loaded} tensors")
    (b0, l0), (b1, l1), (b2, l2) = snaps
    frozen = all(torch.equal(b1[n], v) for n, v in b0.items())
    moved = sum(not torch.equal(b2[n], v) for n, v in b1.items())
    losses = [r[k] for r in reports for k in ("train_loss", "val_loss")]
    if (not frozen or moved == 0 or torch.equal(l1, l0) or torch.equal(l2, l1)
            or not all(math.isfinite(v) for v in losses)):
        raise AssertionError(f"ProtoTree: backbone frozen in epoch 0 {frozen}, "
                             f"tensors moved in epoch 1 {moved}, losses {losses}")
    x = tree.prepare_batch(next(iter(tree.dataloaders["val"])), train=False)["img"]
    save_tree(os.path.join(run_dir, "tree"), tree.model)
    with torch.no_grad():
        tree_same = torch.equal(load_tree(os.path.join(run_dir, "tree"), "cuda").eval()(
            x)["logits"], tree.model.eval()(x)["logits"])
    if not tree_same:
        raise AssertionError("load_tree gives other logits")
    top1 = _tester_matches(torch, tree, "ProtoTreeNet.yaml", run_dir, tree_over)
    del tree, x
    torch.cuda.empty_cache()
    emit("slice_tree_dcl", recipe="prototree", config="ProtoTreeNet.yaml", batch=64,
         image_size=224, height=9, num_features=256, pretrain_tensors_loaded=n_loaded,
         backbone_frozen_epoch0=frozen, backbone_tensors_moved_epoch1=moved,
         leaves_moved_each_epoch=True, save_load_tree_logits_equal=tree_same,
         epochs=reports, tester_top1=top1, tester_logits_equal_trainer=True, **rep)

    # DCL: configs/DCL.yaml, ResNet-50 448x448, batch 8 -> 16 rows, SGD with
    # the head at lr_ratio x the LR; host pipeline, then device
    for pipeline in ("host", "device"):
        over = {"experiment": {"log_dir": run_dir, "name": f"dcl_{pipeline}"},
                "dataset": {"name": "synthetic", "length": 32, "num_workers": 8,
                            "num_classes": 200, "pipeline": pipeline},
                "model": {"num_classes": 200}, "train": {"epoch": 1}}
        dcl, rep = _train_stage(torch, DCLTrainer, "DCL.yaml", run_dir, over,
                                ZERO_LAUNCHES)
        cfg = dcl.config
        groups = {g["label"]: g["lr"] for g in dcl.optimizer.param_groups}
        batch = dcl.prepare_batch(next(iter(dcl.dataloaders["train"])), train=True)
        if pipeline == "device":
            batch = dcl.device_prepare_train(dcl.aug_generator, batch)
        if (int(cfg.dataset.batch_size) != 8 or tuple(batch["img"].shape) != (16, 448, 448, 3)
                or tuple(batch["swap_law"].shape) != (16, 49) or dcl.step != 4
                or abs(groups["head"] / groups["base"] - 10.0) > 1e-9
                or cfg.train.optimizer.name != "SGD"):
            raise AssertionError(f"DCL ({pipeline}): batch {tuple(batch['img'].shape)}, "
                                 f"{dcl.step} steps, groups {groups}")
        top1 = _tester_matches(torch, dcl, "DCL.yaml", run_dir, over)
        del dcl, batch
        torch.cuda.empty_cache()
        emit("slice_tree_dcl", recipe="dcl", config="DCL.yaml", pipeline=pipeline,
             batch=8, rows=16, image_size=448, group_lrs=groups, tester_top1=top1,
             tester_logits_equal_trainer=True, **rep)

    for name, batch in (("prototree", 64), ("dcl", 8)):
        trainer = bench_trainer(name, run_dir, batch)
        r = _train_rate(torch, trainer, name, batch)
        del trainer
        torch.cuda.empty_cache()
        note = ("rows: the 2 x 8 [unswapped; swapped] images the model sees per "
                "step, as bench_methods.py counts DCL" if name == "dcl" else
                "epoch 0: the backbone's gradients zeroed by the gate")
        _emit_rate(torch, name, r, {k: 0.0 for k in ZERO_LAUNCHES},
                   phase="throughput_tree_dcl", counts=note)


# ----------------------------------------------------------------------------
# phases 20-22: the sixth slice, NTS-Net and AP-CNN through their Example
# trainers
# ----------------------------------------------------------------------------
# card against CPU, relative to each tensor's largest value, the whole model
# in float64: logits, gradients and running statistics (held, with the
# picks identical); float32 printed
REGION_F64_TOL = 1e-8
# AP-CNN's heads' biases before their second, train-mode BatchNorm: 0 in
# exact arithmetic, held below REGION_F64_TOL of the model's largest gradient
REGION_ZERO_GRADS = {"apcnn": tuple(f"{h}.{n}.bias" for h in ("cls3", "cls4", "cls5",
                                                               "cls_concate")
                                    for n in ("bn1", "fc1"))}
# the dropblock's draws for the 4 images: a level-3 ROI dropped, a level-4
# one, none, a level-3 one
APCNN_DRAWS = {"pro": (0.1, 0.45, 0.8, 0.2), "i3": (0, 3, 1, 4), "i4": (2, 0, 1, 1)}
# recipe -> (config, Example module, trainer class, input size, batch)
REGION_RECIPES = {"ntsnet": ("NTSNet.yaml", "NTSNet", "NTSNetTrainer", 224, 4),
                  "apcnn": ("APCNN.yaml", "APCNN", "APCNNTrainer", 448, 8)}


def _region_case(torch, name, dtype, dev, fused=False):
    """One train-mode forward and backward of NTS-Net (ResNet-18, 64x64,
    ``pad_side = part_size = 64``, M = 6, K = 4, dropout off: the two
    devices draw other masks) or AP-CNN (the recipe's ResNet-50, 64x64, the
    dropblock on APCNN_DRAWS), 200 classes, batch 4, BatchNorm scales and
    biases at random, through the method's loss on ``dev``: (logits,
    {parameter: gradient}, {buffer: running statistic}, the greedy picks:
    NTS-Net's [B, M] per forward, AP-CNN's ``rois``)."""
    from hawkeye_tpu_torch.losses.apcnn import APCNNLoss
    from hawkeye_tpu_torch.losses.nts import NTSLoss
    from hawkeye_tpu_torch.models import init_parameters
    from hawkeye_tpu_torch.models.methods.apcnn import APCNN
    from hawkeye_tpu_torch.models.methods.ntsnet import NTSNet

    if name == "ntsnet":
        m = NTSNet(200, image_size=64, pad_side=64, part_size=64, backbone_name="resnet18",
                   dtype=dtype, fused_part_pass=fused)
        m.dropout_rate = 0.0
    else:
        m = APCNN(200, image_size=64, dtype=dtype)
    gen = torch.Generator().manual_seed(31)
    init_parameters(m, gen)
    _bn_at_random(torch, m, gen)
    if dtype == torch.float64:
        m.double()
    m.to(dev).train()
    x = torch.randn((4, 64, 64, 3), generator=torch.Generator().manual_seed(32)).to(dev, dtype)
    y = torch.tensor([3, 77, 150, 3], device=dev)
    picks = []
    if name == "ntsnet":
        real = m._nms
        m._nms = lambda scores: picks.append(real(scores)) or picks[-1]
        out, crit = m(x), NTSLoss()
    else:
        draws = {k: torch.tensor(v, device=dev) for k, v in APCNN_DRAWS.items()}
        out, crit = m(x, dropblock=draws), APCNNLoss()
        picks.append(out["rois"])
    crit(out, {"label": y}).backward()
    grads = {n: p.grad.detach().double().cpu() for n, p in m.named_parameters()}
    stats = {n: b.detach().double().cpu() for n, b in m.named_buffers() if "running" in n}
    return (out["logits"].detach().double().cpu(), grads, stats,
            [p.detach().cpu() for p in picks])


def check_reference_region(torch):
    """NTS-Net (sequential and fused) and AP-CNN on the card against the
    CPU, TF32 off; and NTS-Net's fused path against its sequential path on
    the card."""
    from hawkeye_tpu_torch.engine.trainer import set_tf32

    set_tf32(False)

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))

    def compare(a, b, zero=()):
        (la, ga, sa, pa), (lb, gb, sb, pb) = a, b
        errs = {n: rel(ga[n], gb[n]) for n in gb if n not in zero}
        worst = max(errs, key=errs.get)
        top = max(float(g.abs().max()) for g in (*ga.values(), *gb.values()))
        return {"logits": rel(la, lb), "grad_max": errs[worst], "grad_worst": worst,
                "stats_max": max(rel(sa[n], sb[n]) for n in sb),
                "zero_grads_of_max": max((float(g[n].abs().max()) / top
                                          for g in (ga, gb) for n in zero), default=0.0),
                "pick_rows_differing": sum(int((p != q).reshape(p.shape[0], -1).any(1).sum())
                                           for p, q in zip(pa, pb)),
                "forwards_picked": len(pb)}

    report, card64 = {}, {}
    for name, fused in (("ntsnet", False), ("ntsnet_fused", True), ("apcnn", False)):
        model = name.split("_")[0]
        row = {}
        for label, dtype in (("float64", torch.float64), ("float32", torch.float32)):
            cpu, card = (_region_case(torch, model, dtype, dev, fused)
                         for dev in ("cpu", "cuda"))
            row[label] = compare(card, cpu, REGION_ZERO_GRADS.get(model, ()))
            if label == "float64":
                card64[name] = card
        report[name] = row
        f64 = row["float64"]
        if (max(f64["logits"], f64["grad_max"], f64["stats_max"],
                f64["zero_grads_of_max"]) > REGION_F64_TOL
                or f64["pick_rows_differing"] != 0 or f64["forwards_picked"] == 0):
            raise AssertionError(f"card vs CPU {name}: {row}")
    fused = compare(card64["ntsnet_fused"], card64["ntsnet"])
    if (max(fused["logits"], fused["grad_max"], fused["stats_max"]) > REGION_F64_TOL
            or fused["pick_rows_differing"] != 0):
        raise AssertionError(f"NTS-Net fused vs sequential on the card: {fused}")
    emit("reference_region", model="NTS-Net resnet18 64x64 b4 pad_side=part_size=64 "
         "M=6 K=4 (dropout off), sequential and fused_part_pass; AP-CNN resnet50 "
         "64x64 b4, dropblock on fixed draws; 200 classes, one train-mode step "
         "through each method's loss, BatchNorm at random; TF32 off",
         rel_err_of_max=report, ntsnet_fused_vs_sequential_card_float64=fused,
         tolerances={"float64": REGION_F64_TOL, "zero_grads": REGION_ZERO_GRADS,
                     "float64_pick_rows_differing": 0})


def _no_host_sync(torch, trainer, forward=None):
    """One train forward and backward of the trainer's model under
    ``torch.cuda.set_sync_debug_mode("error")``: any call that waits for
    the device raises. The batch is on the card before the mode is set.
    ``forward(batch)`` gives the outputs; by default the model takes the
    images and the trainer's model generator."""
    batch = trainer.prepare_batch(next(iter(trainer.dataloaders["train"])), train=True)
    if forward is None:
        generator = trainer.model_generator()

        def forward(b):
            return trainer.model(b["img"], generator=generator)

    trainer.model.train()
    trainer.optimizer.zero_grad(set_to_none=True)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = forward(batch)
        trainer.criterion(out, batch).backward()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return True


def run_region(torch, run_dir):
    """slice_region and throughput_region: NTS-Net and AP-CNN through their
    Example trainers at their recipes' shapes, the Tester, a train forward
    and backward with no host sync, then their train rates. Every kernel's
    launch count must stay 0."""
    import importlib

    from hawkeye_tpu_torch.profile_step import bench_trainer

    for name, (config, module, cls, size, batch) in REGION_RECIPES.items():
        trainer_cls = getattr(importlib.import_module(
            f"hawkeye_tpu_torch.examples.{module}"), cls)
        over = {"experiment": {"log_dir": run_dir},
                "dataset": {"name": "synthetic", "length": 4 * batch, "num_workers": 8,
                            "num_classes": 200},
                "model": {"num_classes": 200}, "train": {"epoch": 1}}
        tr, rep = _train_stage(torch, trainer_cls, config, run_dir, over, ZERO_LAUNCHES)
        cfg = tr.config
        if (int(cfg.dataset.transformer.image_size) != size
                or int(cfg.dataset.batch_size) != batch or tr.step != 4):
            raise AssertionError(f"{config}: {cfg.dataset.transformer.image_size}px "
                                 f"batch {cfg.dataset.batch_size}, {tr.step} steps")
        fields = {}
        if name == "ntsnet":
            m = tr.model
            if (m.proposal_num, m.cat_num, m.fused_part_pass) != (6, 4, False) or \
                    cfg.train.optimizer.name != "Adam":
                raise AssertionError(f"{config}: M {m.proposal_num}, K {m.cat_num}, "
                                     f"fused {m.fused_part_pass}, {cfg.train.optimizer.name}")
            fields.update(proposal_num=6, cat_num=4, part_size=m.part_size)
        else:
            groups = {g["label"]: g["lr"] for g in tr.optimizer.param_groups}
            if (abs(groups["trunk"] / groups["head"] - 0.1) > 1e-9
                    or cfg.train.optimizer.name != "SGD"):
                raise AssertionError(f"AP-CNN group LRs {groups}")
            fields["group_lrs"] = groups
        top1 = _tester_matches(torch, tr, config, run_dir, over)
        no_sync = _no_host_sync(torch, tr)
        del tr
        torch.cuda.empty_cache()
        emit("slice_region", recipe=name, config=config, batch=batch, image_size=size,
             tester_top1=top1, tester_logits_equal_trainer=True,
             tester_launches=ZERO_LAUNCHES, train_forward_backward_no_host_sync=no_sync,
             **fields, **rep)

    for name, (_, _, _, _, batch) in REGION_RECIPES.items():
        trainer = bench_trainer(name, run_dir, batch)
        r = _train_rate(torch, trainer, name, batch)
        del trainer
        torch.cuda.empty_cache()
        note = ("the 4 images of a step, not the 4 + 24 backbone rows"
                if name == "ntsnet" else "the 8 images of a step")
        _emit_rate(torch, name, r, {k: 0.0 for k in ZERO_LAUNCHES},
                   phase="throughput_region", counts=note)


# ----------------------------------------------------------------------------
# phases 23-25: S3N and MGE-CNN: the card against the CPU, their Example
# trainers, their train rates
# ----------------------------------------------------------------------------
# card against CPU, relative to each tensor's largest value, the whole model
# in float64: logits, gradients and running statistics (held, with the peak
# masks and the boxes identical); float32 printed
S3N_MGE_F64_TOL = 1e-8
# recipe -> batch; the config, Example module and trainer class are
# profile_step's
S3N_MGE_BATCHES = {"s3n": 8, "mge": 4}


def _s3n_mge_case(torch, name, dtype, dev, p=0, fused=True, experts_fused=False):
    """One train-mode forward and backward of S3N at phase ``p`` (its draws
    ``u`` from a seeded CPU generator) or MGE-CNN with the labels, then
    MGE-CNN's eval forward (each expert's argmax picks the CAM's class):
    ResNet-18 trunks, 64x64 (S3N 128x128), 200 classes, batch 4, BatchNorm scales and
    biases at random, on ``dev``: (logits, {parameter: gradient}, {buffer:
    running statistic}, the picks: S3N's zoom and inverse peak masks, MGE's
    boxes per crop). S3N runs at 128x128 (a 4x4 c5: several peaks);
    ``experts_fused`` runs MGE-CNN's ``fused_experts`` path."""
    from hawkeye_tpu_torch.losses.mge import MGELoss
    from hawkeye_tpu_torch.losses.s3n import MultiSmoothLoss
    from hawkeye_tpu_torch.models import init_parameters
    from hawkeye_tpu_torch.models.methods import mge
    from hawkeye_tpu_torch.models.methods.s3n import S3N

    size = 128 if name == "s3n" else 64  # S3N: a 4x4 c5, so several peaks
    if name == "s3n":
        m = S3N(200, image_size=size, backbone_name="resnet18", dtype=dtype,
                fused_warp_pass=fused)
    else:
        m = mge.MGECNN(200, image_size=size, backbone_name="resnet18", dtype=dtype,
                       fused_experts=experts_fused)
    gen = torch.Generator().manual_seed(41)
    init_parameters(m, gen)
    _bn_at_random(torch, m, gen)
    if dtype == torch.float64:
        m.double()
    m.to(dev).train()
    x = torch.randn((4, size, size, 3), generator=torch.Generator().manual_seed(42)).to(dev, dtype)
    y = torch.tensor([3, 77, 150, 3], device=dev)
    picks = []
    if name == "s3n":
        real = m._peaks
        m._peaks = lambda *a: picks.append(real(*a)) or picks[-1]
        u = torch.rand((4, 31, 31), generator=torch.Generator().manual_seed(43)).to(dev)
        out = m(x, p=p, u=u)
        MultiSmoothLoss()(out, {"label": y}).backward()
        picks = [t.cpu() for pair in picks for t in pair]
        logits = out["logits"]
    else:
        real = mge.cam_bbox

        def record(*a):
            crops, boxes = real(*a)
            picks.append(boxes.cpu())
            return crops, boxes

        mge.cam_bbox = record
        try:
            out = m(x, labels=y)
            MGELoss()(out, {"label": y}).backward()
            with torch.no_grad():
                logits = torch.cat([out["all_logits"].detach().reshape(-1, 200),
                                    m.eval()(x)["all_logits"].reshape(-1, 200)])
        finally:
            mge.cam_bbox = real
    grads = {n: p_.grad.detach().double().cpu() for n, p_ in m.named_parameters()}
    stats = {n: b.detach().double().cpu() for n, b in m.named_buffers() if "running" in n}
    return logits.detach().double().cpu(), grads, stats, picks


def check_reference_s3n_mge(torch):
    """S3N at each phase (fused warp pass) and MGE-CNN (train with labels,
    then eval) on the card against the CPU, TF32 off; and S3N's two-pass
    form against its fused pass on the card."""
    from hawkeye_tpu_torch.engine.trainer import set_tf32

    set_tf32(False)

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))

    def compare(a, b):
        (la, ga, sa, pa), (lb, gb, sb, pb) = a, b
        errs = {n: rel(ga[n], gb[n]) for n in gb}
        worst = max(errs, key=errs.get)
        return {"logits": rel(la, lb), "grad_max": errs[worst], "grad_worst": worst,
                "stats_max": max(rel(sa[n], sb[n]) for n in sb),
                "picks_differing": sum(int(not torch.equal(p, q)) for p, q in zip(pa, pb)),
                "picks": len(pb),
                # S3N: the zoom and inverse masks' peak counts; MGE: the boxes
                "pick_summary": [int(q.sum()) if q.dtype == torch.bool else q.tolist()
                                 for q in pb]}

    report, card64 = {}, {}
    for name, p in (("s3n_p0", 0), ("s3n_p1", 1), ("s3n_p2", 2), ("mge", 0)):
        model = name.split("_")[0]
        row = {}
        for label, dtype in (("float64", torch.float64), ("float32", torch.float32)):
            cpu, card = (_s3n_mge_case(torch, model, dtype, dev, p) for dev in ("cpu", "cuda"))
            row[label] = compare(card, cpu)
            if label == "float64":
                card64[name] = card
        report[name] = row
        f64 = row["float64"]
        if (max(f64["logits"], f64["grad_max"], f64["stats_max"]) > S3N_MGE_F64_TOL
                or f64["picks_differing"] != 0 or f64["picks"] == 0):
            raise AssertionError(f"card vs CPU {name}: {row}")
    two_pass = {}
    for p in (0, 1, 2):
        row = compare(_s3n_mge_case(torch, "s3n", torch.float64, "cuda", p, fused=False),
                      card64[f"s3n_p{p}"])
        two_pass[f"p{p}"] = row
        if (max(row["logits"], row["grad_max"], row["stats_max"]) > S3N_MGE_F64_TOL
                or row["picks_differing"] != 0):
            raise AssertionError(f"S3N two-pass vs fused on the card, p={p}: {row}")
    emit("reference_s3n_mge", model="S3N resnet18 128x128 b4 at p=0/1/2 (p=1's draws "
         "fixed), fused warp pass; MGE-CNN four resnet18 64x64 b4, train with labels "
         "then eval; 200 classes, one train-mode step through each method's loss, "
         "BatchNorm at random; TF32 off",
         rel_err_of_max=report, s3n_two_pass_vs_fused_card_float64=two_pass,
         tolerances={"float64": S3N_MGE_F64_TOL, "float64_picks_differing": 0})


def _eval_top1(torch, trainer, **kw):
    """The trainer's model's top-1 on its val split, in eval mode, called
    with ``kw``."""
    correct = count = 0
    model = trainer.model.eval()
    with torch.no_grad():
        for batch in trainer.dataloaders["val"]:
            b = trainer.prepare_batch(batch, train=False)
            pred = model(b["img"], **kw)["logits"].argmax(-1)
            correct += int((pred == b["label"]).sum())
            count += int(b["label"].numel())
    return 100.0 * correct / max(count, 1)


def run_s3n_mge(torch, run_dir):
    """slice_s3n_mge and throughput_s3n_mge: S3N through its Example
    trainer at epoch 0 (train phase 0, validation phase 1) and at epoch 20
    (1 and 2), MGE-CNN through its for one epoch; the Tester on each best
    model; a train forward and backward of each with no host sync; then
    their train rates, peak memory and device idle share. Every kernel's
    launch count must stay 0."""
    import importlib

    from hawkeye_tpu_torch.engine import checkpoint as ckpt
    from hawkeye_tpu_torch.ops import LAUNCHES, reset_launches
    from hawkeye_tpu_torch.profile_step import _RECIPES, bench_trainer, profile_batch

    for name, batch in S3N_MGE_BATCHES.items():
        config, module, cls, size = _RECIPES[name]
        trainer_cls = getattr(importlib.import_module(
            f"hawkeye_tpu_torch.examples.{module}"), cls)
        n_steps = 1 if name == "s3n" else 4
        over = {"experiment": {"log_dir": run_dir},
                "dataset": {"name": "synthetic", "length": n_steps * batch,
                            "num_workers": 8, "num_classes": 200},
                "model": {"num_classes": 200}, "train": {"epoch": 1}}
        fields = {}
        if name == "s3n":
            over["train"]["epoch"] = 21
            phases = []

            def prepare(tr):
                tr.total_epoch = 1  # epoch 0 first; epoch 20 below
                real = tr.apply_model

                def apply_model(batch, train):
                    phases.append((tr.epoch, train, tr.train_phase() if train
                                   else tr.eval_phase()))
                    return real(batch, train)

                tr.apply_model = apply_model

            tr, rep0 = _train_stage(torch, trainer_cls, config, run_dir, over,
                                    ZERO_LAUNCHES, prepare=prepare)
            reset_launches()
            tr.start_epoch, tr.total_epoch = 20, 21
            tr.train()
            torch.cuda.synchronize()
            rep = dict(tr.last_report, launches=dict(LAUNCHES), train_steps=tr.step)
            if dict(LAUNCHES) != ZERO_LAUNCHES or not all(
                    math.isfinite(rep[k]) for k in ("train_loss", "val_loss")):
                raise AssertionError(f"{config} epoch 20: {rep}")
            want_phases = [(0, True, 0), (0, False, 1), (20, True, 1), (20, False, 2)]
            if sorted(set(phases)) != sorted(want_phases):
                raise AssertionError(f"{config}: (epoch, train, phase) {sorted(set(phases))}")
            groups = {g["label"]: g["lr"] for g in tr.optimizer.param_groups}
            if (abs(groups["slow"] / groups["cls"] - 1e-5) > 1e-12
                    or abs(groups["base"] / groups["cls"] - 0.1) > 1e-12
                    or tr.config.train.optimizer.name != "SGD"
                    or not tr.model.fused_warp_pass):
                raise AssertionError(f"S3N group LRs {groups}, {tr.config.train.optimizer}")
            fields.update(epoch0=rep0, phases=want_phases, group_lrs=groups)
            # the Tester calls the model at phase 0, as the JAX Tester does
            meter = tr.performance_meters["val"]["acc"]
            if meter.values[-1] != meter.best_value:  # the Tester's model
                ckpt.load_model(os.path.join(tr.log_root, "best_model.msgpack"), tr.model)
            top1 = _tester_matches(torch, tr, config, run_dir, over,
                                   want_top1=_eval_top1(torch, tr))
            gen = tr.model_generator()
            no_sync = _no_host_sync(torch, tr, lambda b: tr.model(b["img"], p=1,
                                                                   generator=gen))
        else:
            tr, rep = _train_stage(torch, trainer_cls, config, run_dir, over,
                                   ZERO_LAUNCHES)
            groups = {g["label"]: g["lr"] for g in tr.optimizer.param_groups}
            if (abs(groups["extractor"] / groups["classifier"] - 0.1) > 1e-12
                    or tr.config.train.optimizer.name != "Adam"):
                raise AssertionError(f"MGE-CNN group LRs {groups}, {tr.config.train.optimizer}")
            fields["group_lrs"] = groups
            top1 = _tester_matches(torch, tr, config, run_dir, over)
            no_sync = _no_host_sync(torch, tr, lambda b: tr.model(b["img"],
                                                                   labels=b["label"]))
        cfg = tr.config
        if (int(cfg.dataset.transformer.image_size) != size
                or int(cfg.dataset.batch_size) != batch):
            raise AssertionError(f"{config}: {cfg.dataset.transformer.image_size}px "
                                 f"batch {cfg.dataset.batch_size}")
        del tr
        torch.cuda.empty_cache()
        emit("slice_s3n_mge", recipe=name, config=config, batch=batch, image_size=size,
             tester_top1=top1, tester_logits_equal_trainer=True,
             tester_launches=ZERO_LAUNCHES, train_forward_backward_no_host_sync=no_sync,
             **fields, **rep)

    for name, batch in S3N_MGE_BATCHES.items():
        trainer = bench_trainer(name, run_dir, batch)
        r = _train_rate(torch, trainer, name, batch)
        del trainer
        torch.cuda.empty_cache()
        prof = profile_batch(name, batch, 5, run_dir)
        note = ("the 8 images of a phase-1 step (epoch 20)" if name == "s3n"
                else "the 4 images of a step, not its 16 backbone rows (three "
                "experts and the gate)")
        _emit_rate(torch, name if name == "s3n" else "mge_cnn", r,
                   {k: 0.0 for k in ZERO_LAUNCHES}, phase="throughput_s3n_mge",
                   counts=note, device_idle_share=prof["device_idle_share"],
                   device_kernel_ms_per_step=prof["device_kernel_ms_per_step"],
                   profiled_wall_ms_per_step=prof["wall_ms_per_step"],
                   ms_per_step_by_category=prof["ms_per_step_by_category"])


# ----------------------------------------------------------------------------
# phases 26-32: the eighth slice (native decode, VGG-BN, data parallelism,
# MGE-CNN's fused experts, Mixup/CutMix)
# ----------------------------------------------------------------------------
DECODE_SIZE = 512  # the device pipeline's resize_size at 448
N_JPEGS = 64
DECODE_REPEATS = 3
DECODE_MEAN_TOL = 12  # tests/test_native_decoder.py: mean |native - PIL|
VGG_BN_F64_TOL = 1e-8
DIST_F64_TOL = 1e-10
MGE_FUSED_TOL = 1e-10
MIXUP_TOL = 1e-6
DIST_WORKER = "--distributed-worker"


def check_native_decoder(torch, run_dir):
    """native_decoder: build the decoder from the checkout (g++ and libjpeg
    on this machine), decode seeded CUB-sized JPEGs (500x375 and 375x500,
    quality 90) at 512 through ``FGDataset(decode_size=512)``: its bytes are
    the native decoder's, within the JAX test's mean tolerance of PIL's
    path; then host decode images/s, native and PIL, at the Baseline
    recipe's loader thread count and at one thread per core. Where the
    library cannot be built (no libjpeg), ``FGDataset`` must give PIL's
    bytes, the reason is printed and only PIL's rate is measured."""
    import numpy as np
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    from hawkeye_tpu_torch.config import load_yaml_config
    from hawkeye_tpu_torch.data import FGDataset, native_decoder
    from hawkeye_tpu_torch.data.dataset import load_rgb
    from hawkeye_tpu_torch.data.transforms_host import center_crop, resize_shorter

    t0 = time.time()
    available = native_decoder.native_available()
    build_seconds = time.time() - t0
    d = os.path.join(run_dir, "jpegs")
    os.makedirs(d)
    rs = np.random.RandomState(0)
    paths = []
    for i in range(N_JPEGS):
        h, w = (375, 500) if i % 3 else (500, 375)
        smooth = np.kron(rs.rand(h // 25, w // 25, 3), np.ones((25, 25, 1)))
        arr = np.clip(smooth * 200 + rs.randn(h, w, 3) * 20, 0, 255).astype(np.uint8)
        paths.append(os.path.join(d, f"{i}.jpg"))
        Image.fromarray(arr).save(paths[-1], quality=90)
    with open(os.path.join(d, "meta.txt"), "w") as f:
        f.writelines(f"{i % 200} {i}.jpg\n" for i in range(N_JPEGS))

    def native(path):
        return native_decoder.decode_resize_center(path, DECODE_SIZE)

    def pil(path):
        return np.asarray(center_crop(resize_shorter(load_rgb(path), DECODE_SIZE),
                                      DECODE_SIZE))

    ds = FGDataset(d, os.path.join(d, "meta.txt"), decode_size=DECODE_SIZE)
    diffs, differing = [], []
    for i, path in enumerate(paths):
        b = pil(path)
        a = native(path) if available else b
        if a is None or not np.array_equal(ds[i]["img"], a):
            raise AssertionError(f"FGDataset's decode of {path} is not the "
                                 f"{'native' if available else 'PIL'} decoder's")
        diffs.append(float(np.abs(a.astype(int) - b.astype(int)).mean()))
        differing.append(float((a != b).mean()))
    if max(diffs) >= DECODE_MEAN_TOL:
        raise AssertionError(f"native vs PIL mean |diff| {max(diffs)}")
    loader_threads = int(load_yaml_config(os.path.join(
        ROOT, "configs", "Baseline.yaml")).dataset.num_workers)
    rates = {}
    for threads in sorted({loader_threads, os.cpu_count() or 1}):
        for name, fn in (("native", native), ("pil", pil)):
            if name == "native" and not available:
                continue
            with ThreadPoolExecutor(threads) as pool:
                list(pool.map(fn, paths[:threads]))  # warm the page cache
                t0 = time.perf_counter()
                list(pool.map(fn, paths * DECODE_REPEATS))
                dt = time.perf_counter() - t0
            rates[f"{name}_{threads}_threads"] = len(paths) * DECODE_REPEATS / dt
    native_rate = rates.get(f"native_{loader_threads}_threads")
    emit("native_decoder", decoder=native_decoder.describe(), native_built=available,
         build_seconds=build_seconds, images=N_JPEGS,
         sizes="500x375 and 375x500, quality 90", decode_size=DECODE_SIZE,
         fgdataset_bytes_equal=("native" if available else "PIL (fallback)"),
         mean_abs_diff_to_pil_max=max(diffs),
         share_of_values_differing_from_pil=sum(differing) / len(differing),
         tolerance_mean=DECODE_MEAN_TOL, loader_threads=loader_threads,
         cpu_count=os.cpu_count(),
         host_decode_images_per_sec_native=(native_rate if available else
                                            "not measured: the decoder did not build"),
         host_decode_images_per_sec_pil=rates[f"pil_{loader_threads}_threads"],
         host_decode_images_per_sec=rates, reads="warm page cache")


def _bcnn_bn_case(torch, dev):
    """One train-mode forward and backward of a small BCNN on VGG-16-BN
    (64x64, batch 4, 200 classes, the whole model in float64 with plain
    pools: the pool kernels take float32 and bf16 only), BatchNorm scales and
    biases at random, on ``dev``: (logits, {parameter: gradient}, {buffer:
    running statistic})."""
    import torch.nn.functional as F

    from hawkeye_tpu_torch.models import init_parameters
    from hawkeye_tpu_torch.models.methods.bcnn import BCNN

    m = BCNN(200, backbone_name="vgg16_bn", efficient_pool=False, dtype=torch.float64)
    gen = torch.Generator().manual_seed(51)
    init_parameters(m, gen)
    _bn_at_random(torch, m, gen)
    m.double().to(dev).train()
    x = torch.randn((4, 64, 64, 3), generator=torch.Generator().manual_seed(52),
                    dtype=torch.float64).to(dev)
    y = torch.tensor([3, 77, 150, 3], device=dev)
    out = m(x)
    F.cross_entropy(out["logits"], y).backward()
    grads = {n: p.grad.detach().cpu() for n, p in m.named_parameters()}
    stats = {n: b.detach().cpu() for n, b in m.named_buffers() if "running" in n}
    return out["logits"].detach().cpu(), grads, stats


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))


def check_reference_vgg_bn(torch):
    """reference_vgg_bn: a small BCNN on VGG-16-BN in float64, card against
    CPU (logits, every gradient, every running statistic within 1e-8 of the
    tensor's largest value; a conv bias under BatchNorm, whose gradient is 0
    in exact arithmetic, of its kernel's); ``fast_dgrad``'s ``dx`` and
    ``dw`` against autograd of the plain conv on the card in float64 (x
    [8, 64, 112, 112], the 64->64 shape it serves); the VGG-16-BN
    classifier's eval forward at 224x224, 200 classes, card against CPU in
    float64. TF32 off."""
    import torch.nn.functional as F

    from hawkeye_tpu_torch import BACKBONE
    from hawkeye_tpu_torch.engine.trainer import set_tf32
    from hawkeye_tpu_torch.models import init_parameters
    from hawkeye_tpu_torch.ops.conv import conv3x3_same_fast_dgrad

    set_tf32(False)
    (lc, gc, sc), (lg, gg, sg) = (_bcnn_bn_case(torch, dev) for dev in ("cpu", "cuda"))

    def grad_err(n):
        scale = gc[n]
        kernel = n[:-len("bias")] + "weight"
        if n.endswith("bias") and kernel in gc and gc[n].dim() == 1 and "features" in n:
            scale = torch.cat([gc[n].flatten(), gc[kernel].flatten()])
        return float((gg[n] - gc[n]).abs().max() / scale.abs().max().clamp_min(1e-300))

    grads = {n: grad_err(n) for n in gc}
    worst = max(grads, key=grads.get)
    bcnn = {"logits": _rel(lg, lc), "grad_max": grads[worst], "grad_worst": worst,
            "stats_max": max(_rel(sg[n], sc[n]) for n in sc), "bn_layers": 13}
    if max(bcnn["logits"], bcnn["grad_max"], bcnn["stats_max"]) > VGG_BN_F64_TOL:
        raise AssertionError(f"BCNN vgg16_bn card vs CPU in float64: {bcnn}")

    g = torch.Generator(device="cuda").manual_seed(53)
    kw = dict(device="cuda", dtype=torch.float64, generator=g)
    x = torch.randn((8, 64, 112, 112), **kw)
    w = torch.randn((64, 64, 3, 3), **kw) * 0.05
    dy = torch.randn((8, 64, 112, 112), **kw)
    xs = [x.clone().requires_grad_() for _ in range(2)]
    ws = [w.clone().requires_grad_() for _ in range(2)]
    conv3x3_same_fast_dgrad(xs[0], ws[0]).backward(dy)
    F.conv2d(xs[1], ws[1], padding=1).backward(dy)
    dgrad = {"dx": _rel(xs[0].grad, xs[1].grad), "dw": _rel(ws[0].grad, ws[1].grad)}
    if max(dgrad.values()) > 1e-10:
        raise AssertionError(f"fast_dgrad against autograd in float64: {dgrad}")

    m = BACKBONE.get("vgg16_bn")(num_classes=200, dtype=torch.float64,
                                  efficient_pool=False)
    gen = torch.Generator().manual_seed(54)
    init_parameters(m, gen)
    _bn_at_random(torch, m, gen)
    m.double().eval()
    x = torch.randn((2, 224, 224, 3), generator=gen, dtype=torch.float64)
    with torch.no_grad():
        want = m(x)["logits"]
        got = m.cuda()(x.cuda())["logits"].cpu()
    classifier = {"logits": _rel(got, want), "shape": list(got.shape)}
    if classifier["logits"] > VGG_BN_F64_TOL:
        raise AssertionError(f"VGG-16-BN classifier card vs CPU: {classifier}")
    del m
    torch.cuda.empty_cache()
    emit("reference_vgg_bn", model="BCNN vgg16_bn 64x64 b4, 200 classes, float64, "
         "BatchNorm at random, one train-mode step; fast_dgrad x [8,64,112,112] float64; "
         "vgg16_bn classifier 224x224 b2 eval float64; TF32 off",
         bcnn_rel_err_of_max=bcnn, fast_dgrad_vs_autograd=dgrad,
         classifier_rel_err_of_max=classifier,
         tolerances={"float64": VGG_BN_F64_TOL, "fast_dgrad": 1e-10})


def run_slice_vgg_bn(torch, run_dir, s1_want, s2_want):
    """slice_vgg_bn: BCNN on ``vgg16_bn`` through its Example trainer at
    448x448, 200 classes, batch 8, synthetic data: stage 1 from
    ``configs/BCNN_S1.yaml``, then stage 2 from ``BCNN_S2.yaml`` with
    ``model.load`` at stage 1's best model, ``fused_pooling: true`` and
    ``experiment.profile: true`` (its trace file must exist), each stage's
    launches equal to the plain BCNN's (``s1_want``, ``s2_want``, from
    phase 5), the Tester equal to the trained model; then one stage-2 step
    with ``model.fast_dgrad: true`` on plain VGG-16. Returns the launches."""
    from hawkeye_tpu_torch.examples.BCNN import BCNNTrainer
    from hawkeye_tpu_torch.models.backbones.norm import BatchNorm

    common = {"dataset": {"name": "synthetic", "length": 32, "num_workers": 8,
                          "num_classes": 200},
              "train": {"epoch": 1}}
    s1_over = dict(common, experiment={"log_dir": run_dir, "name": "bcnn_bn_s1"},
                   model={"num_classes": 200, "backbone": "vgg16_bn"})
    tr, s1 = _train_stage(torch, BCNNTrainer, "BCNN_S1.yaml", run_dir, s1_over, s1_want)
    if sum(isinstance(m, BatchNorm) for m in tr.model.modules()) != 13:
        raise AssertionError("BCNN stage 1 is not on VGG-16 with 13 BatchNorms")
    s1_best = os.path.join(tr.log_root, "best_model.msgpack")
    s1_state = {k: v.detach().cpu().clone() for k, v in tr.model.state_dict().items()}
    del tr
    torch.cuda.empty_cache()

    s2_over = dict(common, experiment={"log_dir": run_dir, "name": "bcnn_bn_s2",
                                       "profile": True},
                   model={"num_classes": 200, "backbone": "vgg16_bn", "load": s1_best,
                          "fused_pooling": True})
    tr, s2 = _train_stage(torch, BCNNTrainer, "BCNN_S2.yaml", run_dir, s2_over, s2_want,
                          loads=s1_state)
    trace = os.path.join(tr.log_root, "profile", "trace.json")
    if not os.path.exists(trace) or os.path.getsize(trace) == 0:
        raise AssertionError(f"experiment.profile wrote no trace at {trace}")
    # the Tester's one val batch and the logits' forward: 5 pools and a Gram each
    top1 = _tester_matches(torch, tr, "BCNN_S2.yaml", run_dir, s2_over, want_launches={
        "pool_fwd": 10, "pool_bwd": 0, "gram_signed_sqrt": 2})
    del tr
    torch.cuda.empty_cache()

    dg_over = {"experiment": {"log_dir": run_dir, "name": "bcnn_fast_dgrad"},
               "dataset": dict(common["dataset"], length=8), "train": {"epoch": 1},
               "model": {"num_classes": 200, "backbone": "vgg16", "load": None,
                         "fused_pooling": True, "fast_dgrad": True}}
    forwards = 1 + 2 * 1  # one step, val_first and the epoch's validation
    dg_want = {"pool_fwd": 5 * forwards, "pool_bwd": 5, "gram_signed_sqrt": forwards}
    tr, dg = _train_stage(torch, BCNNTrainer, "BCNN_S2.yaml", run_dir, dg_over, dg_want)
    if not tr.model.backbone.fast_dgrad:
        raise AssertionError("model.fast_dgrad did not reach the trunk")
    del tr
    torch.cuda.empty_cache()
    emit("slice_vgg_bn", model="BCNN vgg16_bn 448x448 200 classes, synthetic, "
         "BCNN Example trainer", batch=B, stage1=s1, stage2=s2,
         stage2_loaded_stage1_weights=True, stage2_profile_trace=os.path.relpath(
             trace, run_dir), tester_top1=top1, tester_logits_equal_trainer=True,
         launches_equal_plain_bcnn=True, fast_dgrad_vgg16_stage2_step=dg)
    return {k: s1["launches"][k] + s2["launches"][k] + dg["launches"][k]
            for k in ZERO_LAUNCHES}


def run_throughput_vgg_bn(torch, run_dir):
    """throughput_vgg_bn: ``bcnn_bn_train_images_per_sec``, BCNN stage 2 on
    VGG-16-BN at 448x448 (``profile_step --model bcnn_bn``), batch 128 and
    the recipe's 8, with the peak memory and ``profile_step``'s device idle
    share and time by category."""
    from hawkeye_tpu_torch.profile_step import bench_trainer, profile_batch

    for batch in (128, B):
        trainer = bench_trainer("bcnn_bn", run_dir, batch)
        r = _train_rate(torch, trainer, "bcnn_bn", batch)
        del trainer
        torch.cuda.empty_cache()
        prof = profile_batch("bcnn_bn", batch, 5, run_dir)
        _emit_rate(torch, "bcnn_bn", r, {"pool_fwd": 5.0, "pool_bwd": 5.0,
                                         "gram_signed_sqrt": 1.0},
                   phase="throughput_vgg_bn",
                   device_idle_share=prof["device_idle_share"],
                   device_kernel_ms_per_step=prof["device_kernel_ms_per_step"],
                   profiled_wall_ms_per_step=prof["wall_ms_per_step"],
                   ms_per_step_by_category=prof["ms_per_step_by_category"])


def _dist_trainer(torch, case, config, device):
    """The port's Trainer for one case of the distributed phase: ``small``
    a float64 classifier (ResNet-18 at 64x64 and a float64 head on the mean
    of its ``c5``: the Baseline's ``pool`` is float32), ``full`` the
    Baseline recipe's ResNet-50 (bf16 trunk, float32 head)."""
    from hawkeye_tpu_torch import BACKBONE
    from hawkeye_tpu_torch.config import setup_config
    from hawkeye_tpu_torch.engine import Trainer

    class F64Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.backbone = BACKBONE.get("resnet18")(dtype=torch.float64)
            self.fc = torch.nn.Linear(self.backbone.out_channels, 200)
            self.double()

        def forward(self, x):
            return {"logits": self.fc(self.backbone(x)["c5"].mean(dim=(1, 2)))}

    class DistTrainer(Trainer):
        def get_tb_writer(self):
            return None

        def get_model(self, model_config):
            if case == "small":
                return F64Net()
            return super().get_model(model_config)

    return DistTrainer(setup_config(argv=["--config", config]), device=device)


def _dist_step(torch, case, spec, rank=0, world=1, device="cuda:0"):
    trainer = _dist_trainer(torch, case, spec["config"], device)
    trainer.model.load_state_dict(spec["init"])
    per = spec["batch"]["label"].shape[0] // world
    local = {k: v[rank * per:(rank + 1) * per].numpy() for k, v in spec["batch"].items()}
    m = trainer.train_step_call(trainer.prepare_batch(local, train=True), spec["lr"])
    return {"state": {k: v.detach().cpu() for k, v in trainer.model.state_dict().items()},
            "metrics": {k: float(v) for k, v in m.items()},
            "world": [trainer.rank, trainer.world_size],
            "cross_replica": all(getattr(b, "cross_replica", True)
                                 for b in trainer.model.modules())}


def dist_worker(argv):
    """``chip_smoke.py --distributed-worker RANK WORLD PORT DIR``: one rank
    of the distributed phase, in a gloo group over CUDA tensors on the one
    card (NCCL refuses two ranks on one device)."""
    import datetime

    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    rank, world, port = (int(a) for a in argv[:3])
    d = argv[3]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=300))
    try:
        for case in ("small", "full"):
            spec = torch.load(os.path.join(d, f"{case}.pt"), weights_only=False)
            torch.save(_dist_step(torch, case, spec, rank, world),
                       os.path.join(d, f"{case}_rank{rank}.pt"))
    finally:
        dist.destroy_process_group()
    return 0


def run_distributed(torch, run_dir):
    """distributed: one Baseline-shaped train step at a global batch of 16
    on two ranks (``chip_smoke.py --distributed-worker``, gloo over CUDA
    tensors on this card, 8 rows each) against one process at 16, from the
    same weights, through the port's Trainer (the gradient average and
    global-batch BatchNorm): ``small`` in float64 (ResNet-18, 64x64, a
    float64 head), every parameter's update and every running statistic
    within 1e-10 of the tensor's largest value; ``full``, the Baseline
    recipe's ResNet-50 at 448x448 (bf16, Adam), the agreement printed. The
    two ranks' models must be identical, and their mean loss the single
    process's (1e-10 in float64)."""
    import socket

    d = os.path.join(run_dir, "distributed")
    os.makedirs(d)
    ref, before = {}, {}
    for case, size in (("small", 64), ("full", 448)):
        os.makedirs(os.path.join(d, case))
        config = _recipe("Baseline.yaml", os.path.join(d, case), {
            "experiment": {"log_dir": d, "name": f"dist_{case}", "debug": True},
            "dataset": {"name": "synthetic", "length": 16, "batch_size": 16,
                        "num_workers": 0, "num_classes": 200,
                        "transformer": {"image_size": size, "resize_size": size * 8 // 7}},
            "model": {"num_classes": 200},
            # SGD for the float64 case: Adam's first step moves each weight
            # by about the rate whatever its gradient
            **({"train": {"optimizer": {"name": "SGD", "lr": 0.05, "momentum": 0.9,
                                        "weight_decay": 1e-4}}}
               if case == "small" else {})})
        gen = torch.Generator().manual_seed(71)
        batch = {"img": torch.randn((16, size, size, 3), generator=gen),
                 "label": torch.randint(0, 200, (16,), generator=gen)}
        if case == "small":
            batch["img"] = batch["img"].double()
        trainer = _dist_trainer(torch, case, config, "cuda:0")
        init = {k: v.detach().cpu().clone() for k, v in trainer.model.state_dict().items()}
        lr = float(trainer.config.train.optimizer.lr)
        del trainer
        spec = {"config": config, "init": init, "batch": batch, "lr": lr}
        torch.save(spec, os.path.join(d, f"{case}.pt"))
        ref[case] = _dist_step(torch, case, spec)
        before[case] = init
        torch.cuda.empty_cache()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.time()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), DIST_WORKER,
                               str(r), "2", str(port), d],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        raise AssertionError("a distributed rank failed:\n" + "\n".join(logs)[-6000:])
    seconds = time.time() - t0
    report = {}
    for case in ("small", "full"):
        ranks = [torch.load(os.path.join(d, f"{case}_rank{r}.pt"), weights_only=False)
                 for r in range(2)]
        if [g["world"] for g in ranks] != [[0, 2], [1, 2]] or not all(
                g["cross_replica"] for g in ranks):
            raise AssertionError(f"{case}: ranks {[g['world'] for g in ranks]}")
        same = all(torch.equal(v, ranks[1]["state"][k]) for k, v in ranks[0]["state"].items())
        errs = {}
        for k, want in ref[case]["state"].items():
            got = ranks[0]["state"][k]
            if not want.is_floating_point():
                continue
            if "running" in k:
                errs[k] = _rel(got.double(), want.double())
            else:  # the update
                b = before[case][k].double()
                errs[k] = _rel(got.double() - b, want.double() - b)
        worst = max(errs, key=errs.get)
        loss = sum(g["metrics"]["loss"] for g in ranks) / 2
        row = {"ranks_identical": same, "update_or_stat_max_rel_err": errs[worst],
               "worst": worst, "loss_two_ranks": loss,
               "loss_one_process": ref[case]["metrics"]["loss"],
               "loss_rel_err": abs(loss - ref[case]["metrics"]["loss"])
               / abs(ref[case]["metrics"]["loss"])}
        report[case] = row
        if not same or (case == "small" and max(errs[worst], row["loss_rel_err"])
                        > DIST_F64_TOL):
            raise AssertionError(f"distributed {case}: {row}")
    emit("distributed", ranks=2, backend="gloo (CUDA tensors, one card)",
         global_batch=16, small_model="ResNet-18 64x64 with a float64 head, float64, SGD",
         full_model="Baseline ResNet-50 448x448 bf16 trunk, the recipe's Adam",
         workers_seconds=seconds, tolerance_small=DIST_F64_TOL, **report)


def check_mge_fused(torch, run_dir):
    """mge_fused: MGE-CNN's ``fused_experts`` against its sequential path on
    the card in float64 (ResNet-18 trunks, 64x64, batch 4, a train step
    with the labels, then the eval forward): logits, every gradient and
    every running statistic within 1e-10 of the tensor's largest value and
    the crop boxes identical; then ``mge_cnn_fused_train_images_per_sec``
    beside the sequential rate at the recipe's batch 4, 224x224."""
    from hawkeye_tpu_torch.profile_step import bench_trainer

    seq, fused = (_s3n_mge_case(torch, "mge", torch.float64, "cuda", experts_fused=f)
                  for f in (False, True))
    (ls, gs, ss, ps), (lf, gf, sf, pf) = seq, fused
    grads = {n: _rel(gf[n], gs[n]) for n in gs}
    worst = max(grads, key=grads.get)
    row = {"logits": _rel(lf, ls), "grad_max": grads[worst], "grad_worst": worst,
           "stats_max": max(_rel(sf[n], ss[n]) for n in ss),
           "boxes_differing": sum(int(not torch.equal(p, q)) for p, q in zip(pf, ps)),
           "boxes": len(ps)}
    if (max(row["logits"], row["grad_max"], row["stats_max"]) > MGE_FUSED_TOL
            or row["boxes_differing"] or len(pf) != len(ps)):
        raise AssertionError(f"MGE fused vs sequential on the card: {row}")
    rates = {}
    for name in ("mge", "mge_fused"):
        trainer = bench_trainer(name, run_dir, 4)
        if trainer.model.fused_experts != (name == "mge_fused"):
            raise AssertionError(f"{name}: fused_experts {trainer.model.fused_experts}")
        rates[name] = _train_rate(torch, trainer, name, 4)
        del trainer
        torch.cuda.empty_cache()
        if rates[name]["launches_per_step"] != {k: 0.0 for k in ZERO_LAUNCHES}:
            raise AssertionError(f"{name} launched {rates[name]['launches_per_step']}")
    emit("mge_fused", model="MGE-CNN four resnet18 64x64 b4 float64, 200 classes; "
         "rates: four resnet50 224x224 b4 bf16, Adam", fused_vs_sequential_float64=row,
         tolerance=MGE_FUSED_TOL,
         mge_cnn_fused_train_images_per_sec=rates["mge_fused"]["images_per_sec"],
         mge_cnn_train_images_per_sec=rates["mge"]["images_per_sec"],
         fused=rates["mge_fused"], sequential=rates["mge"],
         device=torch.cuda.get_device_name(0), nvidia_smi=nvidia_smi_line())


def check_mixup(torch):
    """mixup: Mixup and CutMix of a batch of 32 448x448 images on the card
    against the CPU at the same draws (from a seeded CPU generator): the
    images and soft labels within 1e-6, CutMix's mask identical; and the
    time of one call drawing on the card, between CUDA events over 10
    calls (host time included where it is longer)."""
    from hawkeye_tpu_torch.data.mixup import draw, mixup_cutmix

    gen = torch.Generator().manual_seed(61)
    images = torch.rand((32, 448, 448, 3), generator=gen)
    labels = torch.randint(0, 200, (32,), generator=gen)
    rows = {}
    for kind in ("mixup", "cutmix"):
        d = {k: v.item() for k, v in draw(gen).items()}
        d.update(apply=True, cutmix=kind == "cutmix")
        cpu = mixup_cutmix(images, labels, 200, draws=d)
        card = [t.cpu() for t in mixup_cutmix(images.cuda(), labels.cuda(), 200, draws=d)]
        rolled = torch.roll(images, 1, 0)
        mask_same = torch.equal((card[0] == rolled).all(-1), (cpu[0] == rolled).all(-1))
        rows[kind] = {"lam": d["lam"], "images_max_abs_err": float((card[0] - cpu[0]).abs().max()),
                      "labels_max_abs_err": float((card[1] - cpu[1]).abs().max()),
                      "mask_identical": mask_same}
        if max(rows[kind]["images_max_abs_err"], rows[kind]["labels_max_abs_err"]) > MIXUP_TOL \
                or not mask_same:
            raise AssertionError(f"mixup {kind} card vs CPU: {rows[kind]}")
    img, lab = images.cuda(), labels.cuda()
    g = torch.Generator(device="cuda").manual_seed(62)
    for _ in range(3):  # warm-up
        mixup_cutmix(img, lab, 200, p=1.0, generator=g)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(10):  # a generator's draws cannot be captured in a CUDA graph
        mixup_cutmix(img, lab, 200, p=1.0, generator=g)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / 10
    emit("mixup", batch=32, image_size=448, tolerance=MIXUP_TOL, **rows,
         ms_per_call_drawing_on_the_card=ms)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from hawkeye_tpu_torch.ops import _build

    t_start = time.time()
    smi = nvidia_smi_line()
    nvcc = _build.nvcc_path()
    nvcc_version = subprocess.run([nvcc, "--version"], capture_output=True,
                                  text=True, check=True).stdout.strip().splitlines()[-1]
    try:
        import triton
        triton_version = triton.__version__
    except ImportError:
        triton_version = None
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         nvcc=nvcc_version, triton=triton_version, python=sys.version.split()[0],
         device=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         nvidia_smi=smi)

    t0 = time.time()
    paths = _build.build()
    regs = [ln.strip() for log in _build.BUILD_LOG.values()
            for ln in log.splitlines() if "registers" in ln]
    build_seconds = time.time() - t0
    sass = {src: sass_counts(p, nvcc) for src, p in paths.items()}
    emit("build", seconds=build_seconds,
         libraries=[os.path.relpath(p, ROOT) for p in paths.values()],
         flags=" ".join(_build.NVCC_FLAGS), ptxas=regs, sass=sass)
    if sass["gram.cu"]["HGMMA"] == 0:
        raise AssertionError(f"the Gram library has no HGMMA instruction: {sass}")

    kernels = check_kernels(torch)
    check_reference(torch)

    run_dir = os.path.join(ROOT, "_smoke_run")
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    try:
        trainer, launches, s1_launches = run_slice(torch, run_dir)
        s2_launches = dict(launches)
        run_throughput(torch, trainer)
        del trainer
        torch.cuda.empty_cache()
        check_reference_resnet(torch)
        run_slice_resnet(torch, run_dir)
        run_throughput_resnet(torch, run_dir)
        check_kernels_highorder(torch)
        check_reference_highorder(torch)
        for k, v in run_highorder(torch, run_dir).items():
            launches[k] += v
        check_reference_pairs(torch)
        run_pairs(torch, run_dir)
        check_reference_tree_dcl(torch)
        run_tree_dcl(torch, run_dir)
        check_reference_region(torch)
        run_region(torch, run_dir)
        check_reference_s3n_mge(torch)
        run_s3n_mge(torch, run_dir)
        check_native_decoder(torch, run_dir)
        check_reference_vgg_bn(torch)
        for k, v in run_slice_vgg_bn(torch, run_dir, s1_launches, s2_launches).items():
            launches[k] += v
        run_throughput_vgg_bn(torch, run_dir)
        run_distributed(torch, run_dir)
        check_mge_fused(torch, run_dir)
        check_mixup(torch)
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)

    emit("total", seconds=time.time() - t_start)
    sources = {"pool_fwd": ("hawkeye_tpu_torch/csrc/pool.cu",
                            "hawkeye_tpu/ops/pallas_pool.py:110"),
               "pool_bwd": ("hawkeye_tpu_torch/csrc/pool.cu",
                            "hawkeye_tpu/ops/pallas_pool.py:131"),
               "gram_signed_sqrt": ("hawkeye_tpu_torch/csrc/gram.cu",
                                    "hawkeye_tpu/ops/pallas_bilinear.py:63")}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": kernels[name]["max_abs_err"],
         "ms": kernels[name]["ms"], "plain_ms": kernels[name]["plain_ms"],
         "bound_ms": kernels[name]["bound_ms"],
         "bound_by": kernels[name]["bound_by"],
         "library_ms": kernels[name]["library_ms"]}
        for name, (src, rep) in sources.items()]}), flush=True)
    print(nvidia_smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == [DIST_WORKER]:
        sys.exit(dist_worker(sys.argv[2:]))
    sys.exit(main())
