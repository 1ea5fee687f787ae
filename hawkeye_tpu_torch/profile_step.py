"""Where the BCNN stage-2 train step spends its device time.

    python -m hawkeye_tpu_torch.profile_step [--batch 8,128] [--steps 5]

Builds the port's Trainer from ``configs/BCNN_S2.yaml`` (VGG-16, 448x448,
200 classes, ``fused_pooling: true``, random weights, synthetic data) on the
CUDA device and, for each batch size, times ``--steps`` train steps on
device-resident random inputs with a sync at each end, then profiles the
same number of steps with ``torch.profiler``. Prints one JSON line per batch
size: wall ms per step, device kernel ms per step (sum of kernel times; one
stream, so kernels do not overlap), the device idle share, kernel time by
category and the top kernels, and the three ported kernels' device time per
launch. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import time

import torch

from .config import ConfigNode, load_yaml_config
from .engine import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# kernel-name substring -> ported kernel (the Gram has a bf16 wgmma kernel
# and a float32 FMA kernel, both named gram_signed_sqrt_*)
_PORTED = {"pool_fwd_kernel": "pool_fwd", "pool_bwd_kernel": "pool_bwd",
           "gram_signed_sqrt": "gram_signed_sqrt"}


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
    if "reduce" in low or "norm" in low:
        return "reduction"
    return "elementwise/other"


def _trainer(run_dir, batch):
    cfg = load_yaml_config(os.path.join(ROOT, "configs", "BCNN_S2.yaml")).to_dict()
    cfg["experiment"].update(log_dir=run_dir, name=f"profile_b{batch}", debug=True)
    cfg["dataset"] = {"name": "synthetic", "length": batch, "batch_size": batch,
                      "num_workers": 0, "num_classes": 200,
                      "transformer": cfg["dataset"]["transformer"]}
    cfg["model"].update(load=None, fused_pooling=True, num_classes=200)
    return Trainer(ConfigNode(cfg).freeze())


def profile_batch(batch, steps, run_dir):
    trainer = _trainer(run_dir, batch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    batches = [{"img": torch.randn((batch, 448, 448, 3), device="cuda",
                                   generator=gen),
                "label": torch.randint(0, 200, (batch,), device="cuda",
                                       generator=gen)} for _ in range(steps)]
    lr = float(trainer.config.train.optimizer.lr)
    for b in batches[:3]:
        trainer.train_step_call(b, lr)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches:
        trainer.train_step_call(b, lr)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / steps * 1e3

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
    ported = {}
    for name, (t, n) in kernels.items():
        c = _category(name)
        cats[c] = cats.get(c, 0.0) + t / steps / 1e3
        if c in _PORTED.values():
            ported[c] = {"us_per_launch": t / n, "launches_per_step": n / steps}
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
    del trainer, batches
    torch.cuda.empty_cache()
    return {
        "batch": batch, "steps": steps, "wall_ms_per_step": wall_ms,
        "images_per_sec": batch / wall_ms * 1e3,
        "device_kernel_ms_per_step": device_ms,
        "device_idle_share": max(0.0, 1.0 - device_ms / wall_ms),
        "ms_per_step_by_category": dict(sorted(cats.items(), key=lambda kv: -kv[1])),
        "ported_kernels": ported,
        "top_kernels_ms_per_step": [[k[:90], t / steps / 1e3] for k, (t, _) in top],
    }


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", default="8,128")
    parser.add_argument("--steps", type=int, default=5)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_step needs a CUDA device")
    run_dir = os.path.join(ROOT, "_smoke_run", "profile")
    shutil.rmtree(run_dir, ignore_errors=True)
    try:
        for b in (int(x) for x in args.batch.split(",")):
            row = profile_batch(b, args.steps, run_dir)
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
