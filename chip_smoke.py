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

Then a ``kernels`` JSON line (pool kernels at batch 8; the Gram at batch
128, where its 134 MB output cannot stay in the 50 MB L2 between replays),
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
POOL_SHAPES = [(B, 448, 448, 64), (B, 224, 224, 128), (B, 112, 112, 256),
               (B, 56, 56, 512), (B, 28, 28, 512)]
GRAM_SHAPES = [(B, 196, 512), (128, 196, 512)]  # recipe batch, throughput batch
GRAM_RTOL, GRAM_ATOL = 1e-4, 1e-5


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


# ----------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ----------------------------------------------------------------------------
def check_kernels(torch):
    import torch.nn.functional as F

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
        b, h, w, c = shape
        n = b * h * w * c
        x = torch.randn(shape, device=dev, generator=gen).to(bf16)
        p, idx = pool.pool_fwd(x)
        p_ref, idx_ref = pool.pool_fwd_plain(x)
        torch.cuda.synchronize()
        if not (torch.equal(p, p_ref) and torch.equal(idx, idx_ref)):
            raise AssertionError(f"pool_fwd differs from plain at {shape}")
        dp = torch.randn(p.shape, device=dev, generator=gen).to(bf16)
        dx = pool.pool_bwd(dp, idx, p)
        dx_ref = pool.pool_bwd_plain(dp, idx, p)
        torch.cuda.synchronize()
        if not torch.equal(dx, dx_ref):
            raise AssertionError(f"pool_bwd differs from plain at {shape}")
        for name, err in (("pool_fwd", (p.float() - p_ref.float()).abs().max()),
                          ("pool_bwd", (dx.float() - dx_ref.float()).abs().max())):
            rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], float(err))

        # the library's yardsticks (the port calls neither): relu then
        # max_pool2d with indices on channels-last, and max_pool2d's backward
        x_cl = x.permute(0, 3, 1, 2)
        xr_cl = F.relu(x_cl)
        _, lib_idx = F.max_pool2d(xr_cl, 2, 2, return_indices=True)
        dp_cl = dp.permute(0, 3, 1, 2)
        t = {
            "fwd": cuda_ms(torch, lambda: pool.pool_fwd(x)),
            "fwd_plain": cuda_ms(torch, lambda: pool.pool_fwd_plain(x)),
            "fwd_lib": cuda_ms(torch, lambda: F.max_pool2d(
                F.relu(x_cl), 2, 2, return_indices=True)),
            "bwd": cuda_ms(torch, lambda: pool.pool_bwd(dp, idx, p)),
            "bwd_plain": cuda_ms(torch, lambda: pool.pool_bwd_plain(dp, idx, p)),
            "bwd_lib": cuda_ms(torch, lambda: torch.ops.aten.max_pool2d_with_indices_backward(
                dp_cl, xr_cl, [2, 2], [2, 2], [0, 0], [1, 1], False, lib_idx)),
        }
        # bytes each function must move: fwd reads x (2N) and writes p (N/2)
        # and codes (N/4); bwd reads dp, p (N/2 each) and codes (N/4) and
        # writes dx (2N). Operations: ~7 float32 compare/max per pooled value.
        fb, bb = 2.75 * n, 3.25 * n
        ops = 7 * n / 4
        for name, key, byt in (("pool_fwd", "fwd", fb), ("pool_bwd", "bwd", bb)):
            r = rows[name]
            r["ms"] += t[key]
            r["plain_ms"] += t[key + "_plain"]
            r["library_ms"] += t[key + "_lib"]
            r["bytes"] += byt
            r["ops"] += ops
        bf, _ = bound(fb, ops, PEAK_F32_S)
        bbd, _ = bound(bb, ops, PEAK_F32_S)
        per_shape.append({"shape": list(shape), "fwd_ms": t["fwd"],
                          "fwd_bound_ms": bf, "bwd_ms": t["bwd"],
                          "bwd_bound_ms": bbd, "fwd_plain_ms": t["fwd_plain"],
                          "bwd_plain_ms": t["bwd_plain"],
                          "fwd_library_ms": t["fwd_lib"],
                          "bwd_library_ms": t["bwd_lib"]})
        del x, p, idx, p_ref, idx_ref, dp, dx, dx_ref, x_cl, xr_cl, lib_idx, dp_cl

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


def run_slice(torch, run_dir):
    from hawkeye_tpu_torch.config import setup_config
    from hawkeye_tpu_torch.engine import Trainer
    from hawkeye_tpu_torch.ops import LAUNCHES, reset_launches

    class SmokeTrainer(Trainer):
        def report(self, epoch, lr, train_metrics, val_metrics, images_per_sec):
            self.last_report = dict(train_loss=train_metrics["loss"],
                                    train_acc=train_metrics["acc"],
                                    val_loss=val_metrics["loss"],
                                    val_acc=val_metrics["acc"],
                                    images_per_sec=images_per_sec)

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
    return s2, s2_launches


def run_throughput(torch, trainer, batch=128, warmup=3, timed=10):
    from hawkeye_tpu_torch.ops import LAUNCHES, reset_launches

    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    batches = [{"img": torch.randn((batch, 448, 448, 3), device="cuda",
                                   generator=gen),
                "label": torch.randint(0, 200, (batch,), device="cuda",
                                       generator=gen)}
               for _ in range(timed)]
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
    loss = float(m["loss"])
    if not math.isfinite(loss):
        raise AssertionError(f"throughput step loss {loss}")
    per_step = {k: v / timed for k, v in LAUNCHES.items()}
    if per_step != {"pool_fwd": 5, "pool_bwd": 5, "gram_signed_sqrt": 1}:
        raise AssertionError(f"launches per step {per_step}")
    emit("throughput", bcnn_train_images_per_sec=batch * timed / dt,
         batch=batch, image_size=448, dtype="bfloat16", warmup_steps=warmup,
         timed_steps=timed, ms_per_step=dt / timed * 1e3, last_loss=loss,
         peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
         launches_per_step=per_step, device=torch.cuda.get_device_name(0),
         nvidia_smi=nvidia_smi_line())


# ----------------------------------------------------------------------------
# phases 8 and 9: Baseline ResNet-50 through the Trainer and the Tester, then
# throughput
# ----------------------------------------------------------------------------
def run_slice_resnet(torch, run_dir, n_train=96):
    from hawkeye_tpu_torch.config import setup_config
    from hawkeye_tpu_torch.engine import Tester, Trainer
    from hawkeye_tpu_torch.ops import LAUNCHES, reset_launches

    class SmokeTrainer(Trainer):
        def report(self, epoch, lr, train_metrics, val_metrics, images_per_sec):
            self.last_report = dict(train_loss=train_metrics["loss"],
                                    train_acc=train_metrics["acc"],
                                    val_loss=val_metrics["loss"],
                                    val_acc=val_metrics["acc"],
                                    images_per_sec=images_per_sec)

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


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from hawkeye_tpu_torch.ops import _build

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
        trainer, launches = run_slice(torch, run_dir)
        run_throughput(torch, trainer)
        del trainer
        torch.cuda.empty_cache()
        check_reference_resnet(torch)
        run_slice_resnet(torch, run_dir)
        run_throughput_resnet(torch, run_dir)
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)

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
    sys.exit(main())
