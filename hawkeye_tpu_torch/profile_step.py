"""Where a train step spends its device time.

    python -m hawkeye_tpu_torch.profile_step
        [--model bcnn|resnet50|cbcnn|mpn|peer_learning|pair_confusion|
                 osme|apinet|cin|crossx|interp_parts|prototree|dcl|
                 ntsnet|apcnn|s3n|mge]
        [--batch 8,128] [--steps 5]

``--model bcnn`` (the default) builds the port's Trainer from
``configs/BCNN_S2.yaml`` (VGG-16, 448x448, 200 classes,
``fused_pooling: true``) and feeds it device-resident random float images.
``--model resnet50`` builds it from ``configs/Baseline.yaml`` (Baseline
ResNet-50, 448x448, 200 classes) with ``bench.py``'s train step: SGD (lr
0.01, momentum 0.9, weight decay 1e-4) and the device pipeline on
device-resident uint8 ``[B, 512, 512, 3]`` images, augmented on the card by
random-resized crop with the flip, normalisation and erasing (p 0.1), no
TA-wide, bfloat16 out. The other four build their Example trainer
(``examples/``) from the recipe at its own input size, on device-resident
random float images: ``cbcnn`` from ``configs/CBCNN_S2.yaml`` (448x448,
d = 6000), ``mpn`` from ``configs/MPN.yaml`` (ResNet-50, 224x224),
``peer_learning`` from ``configs/PeerLearning_BCNN_S2.yaml`` (two BCNN
VGG-16 peers, 224x224, ``fused_pooling: true``, drop rate 0.25) and
``pair_confusion`` from ``configs/PC_resnet50.yaml`` (Baseline ResNet-50,
224x224), ``osme`` from ``configs/OSMENet.yaml`` (ResNet-101, 224x224),
``apinet`` from ``configs/APINet.yaml`` (ResNet-101, 224x224, a step past
epoch 0, whose gate zeroes the backbone's gradients), ``cin`` from
``configs/CIN.yaml`` (ResNet-50, 224x224), ``crossx`` from
``configs/CrossX.yaml`` (448x448), ``interp_parts`` from
``configs/InterpPartsNet.yaml`` (IP-ResNet-101, K = 5, 448x448),
``prototree`` from ``configs/ProtoTreeNet.yaml`` (ResNet-50, 224x224,
height 9, D = 256; epoch 0, so the backbone's gradients are zeroed, and
the leaf update after each step) and ``dcl`` from ``configs/DCL.yaml``
(ResNet-50, 448x448): its batches are what its host collate gives, 2B rows
``[unswapped; swapped]`` with their swap labels and laws, and its rates
count the 2B rows the model sees (``bench_methods.py`` counts them so too),
``ntsnet`` from ``configs/NTSNet.yaml`` (ResNet-50, 224x224, M = 6; its
rates count the B images, not the B + B*M backbone rows), ``apcnn``
from ``configs/APCNN.yaml`` (ResNet-50, 448x448), ``s3n`` from
``configs/S3N.yaml`` (ResNet-50, 448x448, at epoch 20: the phase-1 step of
80 of its 100 epochs) and ``mge`` from ``configs/MGE_CNN.yaml`` (four
ResNet-50s, 224x224).
The P x K recipes (OSME, API-Net, CIN) take ``--batch`` as P x K with the
recipe's K (``dataset.n_samples``), and their labels come as P random
classes K times each. Random weights, synthetic data, on the CUDA device.

For each batch size it times ``--steps`` train steps with a sync at each
end, then profiles the same number of steps with ``torch.profiler``. Prints
one JSON line per batch size: wall ms per step, device kernel ms per step
(sum of kernel times; one stream, so kernels do not overlap), the device
idle share, kernel time by category and the top kernels, and the three
ported kernels' device time per launch. A kernel's category comes from the
host op that launched it where that says more than its name: everything
the augmentation launches is ``augmentation``, everything under the
optimizer's step is ``optimizer``; for ``ntsnet`` what its ``_nms`` and
``_crop`` launch (the greedy loop; the padding and the part crops) is
``nms`` and ``roi_crop``, and for ``apcnn`` what ``_rois`` and
``_roi_crop`` launch (the attention masking and the NMS; the dropblock and
the union crop, forward only) is ``nms`` and ``roi_crop``; for ``s3n`` what
``_saliency_grids`` launches (the class response map, its peaks, the
saliency maps, the blur and the grids, forward only) is ``saliency`` and
what ``_warp`` launches (the grid sample) ``warp``, and for ``mge`` what
``_cam_crop`` launches (the CAM, the box and the crop) is ``cam_crop``; for
``cbcnn``
every kernel under an ``aten::bmm`` or ``aten::mm`` (the Gram, the sketch products, the
per-frequency reduction and the irDFT matmuls, forward and backward; not
``fc``'s backward) is ``compact_bilinear``, and for ``mpn`` every kernel
under an ``aten::bmm`` (the covariance and the Newton-Schulz products) is
``covariance_newton_schulz``. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import shutil
import subprocess
import time

import torch

from . import models  # noqa: F401  (registry side effects)
from .config import ConfigNode, load_yaml_config
from .data.dcl import double_batch, permutations_from_keys
from .data.transforms_device import make_train_augment
from .engine import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# kernel-name substring -> ported kernel (the Gram has a bf16 wgmma kernel
# and a float32 FMA kernel, both named gram_signed_sqrt_*)
_PORTED = {"pool_fwd_kernel": "pool_fwd", "pool_bwd_kernel": "pool_bwd",
           "gram_signed_sqrt": "gram_signed_sqrt"}
_AUGMENT = "hk::augment"  # the profiler range around the device augmentation
# model -> {its method: category}: profiler ranges around a model's own steps
_RANGES = {"ntsnet": {"_nms": "nms", "_crop": "roi_crop"},
           "apcnn": {"_rois": "nms", "_roi_crop": "roi_crop"},
           "s3n": {"_saliency_grids": "saliency", "_warp": "warp"},
           "mge": {"_cam_crop": "cam_crop"}}
# model -> (category, host ops whose kernels it takes): the high-order heads
_HEADS = {"cbcnn": ("compact_bilinear", ("aten::bmm", "aten::mm")),
          "mpn": ("covariance_newton_schulz", ("aten::bmm",))}
# recipe, Example module and trainer, input size of the other models
_RECIPES = {"cbcnn": ("CBCNN_S2.yaml", "CBCNN", "CBCNNTrainer", 448),
            "mpn": ("MPN.yaml", "MPN", "MPNTrainer", 224),
            "peer_learning": ("PeerLearning_BCNN_S2.yaml", "PeerLearning",
                              "PLTrainer", 224),
            "pair_confusion": ("PC_resnet50.yaml", "PairConfusion",
                               "PairConfusionTrainer", 224),
            "osme": ("OSMENet.yaml", "OSMENet", "OSMETrainer", 224),
            "apinet": ("APINet.yaml", "APINet", "APINetTrainer", 224),
            "cin": ("CIN.yaml", "CIN", "CINTrainer", 224),
            "crossx": ("CrossX.yaml", "CrossX", "CrossXTrainer", 448),
            "interp_parts": ("InterpPartsNet.yaml", "InterpPartsNet",
                             "InterpPartsTrainer", 448),
            "prototree": ("ProtoTreeNet.yaml", "ProtoTreeNet", "ProtoTreeTrainer", 224),
            "dcl": ("DCL.yaml", "DCL", "DCLTrainer", 448),
            "ntsnet": ("NTSNet.yaml", "NTSNet", "NTSNetTrainer", 224),
            "apcnn": ("APCNN.yaml", "APCNN", "APCNNTrainer", 448),
            "s3n": ("S3N.yaml", "S3N", "S3NTrainer", 448),
            "mge": ("MGE_CNN.yaml", "MGE_CNN", "MGETrainer", 224)}


def recipe_n_samples(model):
    """K of a P x K recipe (``dataset.n_samples``), else None."""
    if model not in _RECIPES:
        return None
    cfg = load_yaml_config(os.path.join(ROOT, "configs", _RECIPES[model][0]))
    k = cfg.dataset.get("n_samples")
    return None if k is None else int(k)


def _category(name: str) -> str:
    low = name.lower()
    for key, cat in _PORTED.items():
        if key in name:
            return cat
    if any(k in low for k in ("conv", "cudnn", "xmma", "implicit", "dgrad",
                              "wgrad", "fprop")):
        return "convolution"
    if any(k in low for k in ("gemm", "cublas", "sm90_x", "splitk")):
        return "matmul"
    if "multi_tensor" in low or "foreach" in low:
        return "optimizer"
    if "batch_norm" in low:
        return "batch_norm"
    if "reduce" in low or "norm" in low:
        return "reduction"
    return "elementwise/other"


def _launch_category(event, head=None) -> str | None:
    """The category that the launching host op, or one above it, sets."""
    names = []
    while event is not None:
        if event.name == _AUGMENT:
            return "augmentation"
        if event.name.startswith("hk::"):
            return event.name[len("hk::"):]
        if event.name.startswith("Optimizer.step"):
            return "optimizer"
        names.append(event.name)
        event = event.cpu_parent
    if head and any(n in head[1] for n in names) and not any(
            "AddmmBackward" in n for n in names):
        return head[0]
    return None


def bench_trainer(model, run_dir, batch, device=None):
    """The port's Trainer for the benchmark step of ``model`` (on CUDA
    unless ``device`` says otherwise)."""
    trainer_cls = Trainer
    if model == "bcnn":
        cfg = load_yaml_config(os.path.join(ROOT, "configs", "BCNN_S2.yaml")).to_dict()
        cfg["dataset"] = {"transformer": cfg["dataset"]["transformer"]}
        cfg["model"].update(load=None, fused_pooling=True)
    elif model in _RECIPES:
        recipe, module, cls, _ = _RECIPES[model]
        trainer_cls = getattr(importlib.import_module(
            f"{__package__}.examples.{module}"), cls)
        cfg = load_yaml_config(os.path.join(ROOT, "configs", recipe)).to_dict()
        k = recipe_n_samples(model)
        cfg["dataset"] = {"transformer": cfg["dataset"]["transformer"]}
        if k is not None:  # P x K with the recipe's K
            cfg["dataset"].update(n_classes=batch // k, n_samples=k)
        cfg["model"].update(load=None)
        if model == "peer_learning":
            cfg["model"]["base_model"].update(fused_pooling=True)
    else:
        cfg = load_yaml_config(os.path.join(ROOT, "configs", "Baseline.yaml")).to_dict()
        cfg["dataset"] = {"pipeline": "device",
                          "transformer": {"image_size": 448, "resize_size": 512,
                                          "auto_augment": "none"}}
        cfg["train"]["optimizer"] = {"name": "SGD", "lr": 0.01, "momentum": 0.9,
                                     "weight_decay": 1e-4}
    cfg["experiment"].update(log_dir=run_dir, name=f"profile_{model}_b{batch}",
                             debug=True)
    cfg["dataset"].update(name="synthetic", length=batch, batch_size=batch,
                          num_workers=0, num_classes=200)
    cfg["model"].update(num_classes=200)
    trainer = trainer_cls(ConfigNode(cfg).freeze(), device=device)
    if model == "resnet50":
        # bench.py's augmentation: crop with the flip, normalize, erase 0.1,
        # bfloat16 out (the trunk computes in bfloat16 anyway)
        trainer.device_augment = make_train_augment(448, out_dtype=torch.bfloat16)
    if model == "apinet":
        trainer.epoch = 1  # past the epoch-0 gate, as 99 of its 100 epochs
    if model == "s3n":
        trainer.epoch = 20  # phase 1, as 80 of its 100 epochs
    return trainer


def bench_lr(trainer):
    """The rate of the recipe's first train step: its scheduler's rate at
    the trainer's epoch (a warm-up's start included), through the per-batch
    hook. From random weights some recipes diverge at their base rate
    (OSME's 0.04 without its warm-up)."""
    return trainer.batch_lr(trainer.scheduler.epoch_lr(trainer.epoch))


def bench_batches(model, batch, n, seed=0, device="cuda"):
    """``n`` device-resident batches, each its own: float images for BCNN
    and the Example trainers' models, the device pipeline's uint8 decodes
    for ResNet-50; P x K labels for the balanced recipes; for DCL the 2x
    ``[unswapped; swapped]`` batch of its host collate (``batch`` images
    give 2 x ``batch`` rows)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    size = _RECIPES[model][3] if model in _RECIPES else 448
    k = recipe_n_samples(model)
    out = []
    for _ in range(n):
        if model == "resnet50":
            img = torch.randint(0, 256, (batch, 512, 512, 3), device=device,
                                dtype=torch.uint8, generator=gen)
        else:
            img = torch.randn((batch, size, size, 3), device=device, generator=gen)
        if k is None:
            label = torch.randint(0, 200, (batch,), device=device, generator=gen)
        else:  # P classes, K images each, as the balanced sampler gives
            label = torch.randperm(200, device=device, generator=gen)[
                :batch // k].repeat_interleave(k)
        out.append({"img": img, "label": label})
        if model == "peer_learning":
            out[-1]["drop_rate"] = 0.25
        if model == "dcl":  # the host collate's weights and jigsaws
            perms = permutations_from_keys(
                *(torch.rand((batch, 7, 7), device=device, generator=gen)
                  for _ in range(2)))
            out[-1] = double_batch(dict(out[-1], weight=torch.ones(batch, device=device)),
                                   img, perms)
    return out


def _ranged(fn, name):
    """``fn`` inside the profiler range ``name``."""
    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)

    return wrapped


def profile_batch(model, batch, steps, run_dir):
    trainer = bench_trainer(model, run_dir, batch)
    if trainer.pipeline == "device":
        augment = trainer.device_augment

        def annotated(generator, images):
            with torch.profiler.record_function(_AUGMENT):
                return augment(generator, images)

        trainer.device_augment = annotated
    for method, category in _RANGES.get(model, {}).items():
        setattr(trainer.model, method, _ranged(getattr(trainer.model, method),
                                               f"hk::{category}"))
    batches = bench_batches(model, batch, steps)
    lr = bench_lr(trainer)
    for b in batches[:3]:
        trainer.train_step_call(b, lr)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches:
        trainer.train_step_call(b, lr)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    rows = batches[0]["img"].shape[0]  # DCL's 2x batch counts its rows

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for b in batches:
            trainer.train_step_call(b, lr)
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.key_averages():
        # device-side activities only (kernels, memcpy, memset): the host op
        # that launched a kernel, and an annotated range such as
        # "Optimizer.step#SGD.step", report the same time again; "Command
        # Buffer Full" is the tracer's marker of a full launch queue
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or e.is_user_annotation or e.key == "Command Buffer Full"):
            continue
        t = e.self_device_time_total
        if t > 0:
            kernels[e.key] = (kernels.get(e.key, (0.0, 0))[0] + t,
                              kernels.get(e.key, (0.0, 0))[1] + e.count)
    if not kernels:
        raise RuntimeError("the profiler recorded no device time")
    device_ms = sum(t for t, _ in kernels.values()) / steps / 1e3
    cats: dict = {}
    for name, (t, _) in kernels.items():
        c = _category(name)
        cats[c] = cats.get(c, 0.0) + t / steps / 1e3
    # then move what the augmentation and the optimizer launched to their
    # own categories; a CUDA API event ("cudaLaunchKernel", ...) can carry a
    # kernel that its calling op carries too, so only ops are read
    for event in prof.events():
        c = _launch_category(event, _HEADS.get(model))
        if c is None or event.name.startswith("cu"):
            continue
        for k in event.kernels:
            d = k.duration / steps / 1e3
            cats[c] = cats.get(c, 0.0) + d
            cats[_category(k.name)] -= d
    ported = {}
    for name, (t, n) in kernels.items():
        c = _category(name)
        if c in _PORTED.values():
            ported[c] = {"us_per_launch": t / n, "launches_per_step": n / steps}
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    del trainer, batches
    torch.cuda.empty_cache()
    return {
        "model": model, "batch": batch, "rows": rows, "steps": steps,
        "wall_ms_per_step": wall_ms,
        "images_per_sec": rows / wall_ms * 1e3,
        "device_kernel_ms_per_step": device_ms,
        "device_idle_share": max(0.0, 1.0 - device_ms / wall_ms),
        "ms_per_step_by_category": dict(sorted(cats.items(), key=lambda kv: -kv[1])),
        "ported_kernels": ported,
        "top_kernels_ms_per_step": [[k[:90], t / steps / 1e3] for k, (t, _) in top],
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--model", default="bcnn",
                        choices=("bcnn", "resnet50", *_RECIPES))
    parser.add_argument("--batch", default="8,128")
    parser.add_argument("--steps", type=int, default=5)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_step needs a CUDA device")
    run_dir = os.path.join(ROOT, "_smoke_run", "profile")
    shutil.rmtree(run_dir, ignore_errors=True)
    try:
        for b in (int(x) for x in args.batch.split(",")):
            row = profile_batch(args.model, b, args.steps, run_dir)
            row["device"] = torch.cuda.get_device_name(0)
            row["nvidia_smi"] = subprocess.run(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], capture_output=True, text=True,
                check=True).stdout.strip()
            print(json.dumps(row), flush=True)
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)


if __name__ == "__main__":
    main()
