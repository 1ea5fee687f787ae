"""One run of one cell on one rank: set-up, the checked steps, the warm-up,
the window, the trace, and the check against the reference.

Set-up builds one object, the Example trainer of the configuration, through
the port's own constructor, with the benchmark's pool as its train dataset
(the port's ``DataLoader`` and, across ranks, its process-sharded sampler
over the benchmark's ``WindowSampler``). It then drives that trainer from
the seed through ``train_epoch`` for the checked steps (distinct rows) and
a warm-up epoch, fixes the window's step count from the warm-up's step time
(rank 0's count, broadcast), and hands the same trainer to the window: one
``train_epoch`` of that many steps, timed from its call to its return,
which synchronises through ``.tolist()``.

After the window: the peak device memory is read, the trace (if any) is
reduced, the program's state is freed, and rank 0 runs the reference over
the checked steps' rows and the per-layer readers. The last step on every
rank is the look for JAX among the process's modules: a rank that finds it
raises ``ForbiddenModules``, and no result is returned.
"""

from __future__ import annotations

import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass

import torch
import torch.distributed as dist

from . import catalog, check, data, probe, trace
from .reference.common import reference_steps

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax", "hawkeye_tpu"})
TRACE_DEVICE_S = 2.5  # device seconds the traced stretch covers at least
TRACE_AFTER = 2  # steps after the traced stretch that its stop can still slow


def forbidden_modules():
    """Top-level names of loaded modules that the benchmark may not load,
    compared whole (``hawkeye_tpu_torch`` is the program)."""
    return sorted({name.split(".")[0] for name in sys.modules} & FORBIDDEN)


def refuse_forbidden():
    bad = forbidden_modules()
    if bad:
        raise ForbiddenModules(bad)


@dataclass
class RunRecord:
    """What a per-layer metric's reader reads."""

    cell: catalog.Cell
    steps: int
    spans: probe.Spans
    summary: trace.Summary | None
    e2e: dict
    step_ms: list  # the window's steps outside the traced stretch (device clock)
    flops_per_image: float
    kernel_work: dict
    chips: int
    profile: trace.Profile | None  # the traced stretch's profiler


class Run:
    """The trainer of one run, from set-up to the end of its window."""

    def __init__(self, cell, seed, device, ranged=False, log_dir=None):
        self.cell = cell
        self.seed = int(seed) % 2**32  # numpy's seeds are 32-bit
        self.ref = catalog.reference_module(cell)
        cfg = cell.run_config(self.seed, log_dir)
        self.cfg = cfg
        decode = int(cfg["dataset"]["transformer"]["resize_size"])
        self.images, self.labels = data.make_pool(
            cell.pool_images, decode, int(cfg["model"]["num_classes"]), self.seed,
            device)
        self.sampler = data.WindowSampler(cell.pool_images, cell.global_batch, self.seed)
        cls = probe.bench_trainer_class(catalog.trainer_class(cell),
                                        data.PoolDataset(self.images, self.labels),
                                        self.sampler)
        from hawkeye_tpu_torch.config import ConfigNode

        self.trainer = cls(ConfigNode(cfg).freeze(),
                           device=None if device.type == "cuda" else device)
        self.device = self.trainer.device
        self.spans = probe.Spans(ranged=ranged)
        self.probe = probe.instrument(self.trainer, self.spans)
        self.lr = self.trainer.scheduler.epoch_lr(0)

    def checked_steps(self):
        """The first steps, through ``train_epoch``: (program readings,
        their global index batches)."""
        self.probe.begin("check")
        self.sampler.plan(int(self.cell.traffic["checked_steps"]), log=True)
        self.trainer.train_epoch(self.lr)
        readings = self.probe.check_readings()
        if dist.is_initialized() and dist.get_world_size() > 1:
            # each rank's loss is its own rows' mean: the global batch's is
            # the mean over the ranks (equal slices)
            t = torch.tensor(readings["losses"], dtype=torch.float64, device=self.device)
            dist.all_reduce(t)
            readings["losses"] = (t / dist.get_world_size()).tolist()
        return readings, self.sampler.log

    def epoch(self, steps, clock=None, profile=None):
        """One ``train_epoch`` of ``steps`` steps: (its metrics, host
        seconds from the call to the return)."""
        self.sampler.plan(steps)
        self.probe.begin("window" if clock is not None else "warmup", clock, profile)
        t0 = time.perf_counter()
        metrics = self.trainer.train_epoch(self.lr)
        return metrics, time.perf_counter() - t0

    def free(self):
        self.trainer.probe = None
        self.probe.trainer = None
        del self.trainer, self.probe
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def _world():
    return (dist.get_rank(), dist.get_world_size()) if dist.is_initialized() else (0, 1)


def _all_reduce(value, device, op):
    t = torch.tensor([float(value)], dtype=torch.float64, device=device)
    if _world()[1] > 1:
        dist.all_reduce(t, op=op)
    return float(t.item())


def _p95(values):
    return statistics.quantiles(values, n=20)[18] if len(values) > 1 else values[0]


def power_limit():
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e!r}"


def reference_readings(run, batches, precision="float32", keep_rows=None, labels=None):
    return reference_steps(run.ref, run.cfg, run.images,
                           run.labels if labels is None else labels, batches,
                           run.seed, run.cell.per_rank, run.device, precision,
                           keep_rows)


def run_rank(cell, seed, seconds, traced, device, t_start, log=print):
    """The whole run on this rank; rank 0 returns the result line (after
    logging an info line), the others None."""
    log_dir = tempfile.mkdtemp(prefix="portbench-")
    try:
        return _run_rank(cell, seed, seconds, traced, device, t_start, log_dir, log)
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)


def _run_rank(cell, seed, seconds, traced, device, t_start, log_dir, log):
    run = Run(cell, seed, device, ranged=traced, log_dir=log_dir)
    dev = run.device
    rank, world = _world()
    program, batches = run.checked_steps()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)

    warmup = int(cell.traffic["warmup_steps"])
    _, warm_s = run.epoch(warmup)
    step_s = warm_s / warmup
    steps = max(2, round(seconds / step_s))
    if world > 1:  # every rank runs rank 0's count of steps and collectives
        t = torch.tensor([steps, step_s], dtype=torch.float64, device=dev)
        dist.broadcast(t, 0)
        steps, step_s = int(t[0].item()), float(t[1].item())
    profile = None
    if traced:  # a stretch in the middle, inside a window of any length
        k = max(5, math.ceil(TRACE_DEVICE_S / step_s))
        steps = max(steps, k + 2)
        profile = ((steps - k) // 2, k, trace.Profile(dev))
    clock = probe.StepClock(dev, steps)
    run.spans.clear()
    handed0 = run.sampler.handed
    setup_s = time.perf_counter() - t_start
    cpu0 = time.process_time()
    metrics, window_s = run.epoch(steps, clock, profile)
    host = {"process_cpu_s": time.process_time() - cpu0,
            "cores": len(os.sched_getaffinity(0))}

    handed = run.sampler.handed - handed0
    count = float(metrics["count"])
    rate = count / window_s
    step_ms = clock.intervals_ms()
    peak = _all_reduce(torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0,
                       dev, dist.ReduceOp.MAX)
    summary = prof = None
    if profile is not None:
        _, k, prof = profile
        summary = trace.summarize(prof.prof.events(), k, prof.window_s)
        summary.busy_s = _all_reduce(summary.busy_s, dev, dist.ReduceOp.SUM) / world
    run.free()
    if world > 1:
        dist.barrier()
        dist.destroy_process_group()
    if rank != 0:
        refuse_forbidden()
        return None

    e2e = {"train_images_per_sec": rate, "step_ms_p95": _p95(step_ms), "setup_s": setup_s}
    info = {"portbench": cell.name, "seed": seed, "steps": steps, "window_s": window_s,
            "warmup_step_s": step_s, "setup_s": setup_s, "memory_peak_bytes": peak,
            "step_ms_median": statistics.median(step_ms), "images": count,
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "power_limit": power_limit() if dev.type == "cuda" else None,
            "kernels_built": sorted(_built_kernels()), "host": host}
    log(json.dumps(info), flush=True)

    t_ref = time.perf_counter()
    ref = reference_readings(run, batches)
    values = check.readings(program, ref)
    ok, rows = check.judge(values, cell.limits)
    rows.append(("images_trained", count, float(steps * cell.global_batch)))
    rows.append(("images_handed_out", float(handed), float(steps * cell.global_batch)))
    counted = count == steps * cell.global_batch == handed
    info_ref = time.perf_counter() - t_ref
    log(json.dumps({"portbench_reference_s": info_ref, "readings": values,
                    "program": program["losses"], "reference": ref["losses"],
                    "program_lr": run.lr, "reference_lr": ref["rate"],
                    "reference_leaves_at": ref["leaves_at"]}), flush=True)

    if traced:
        first, k, _ = profile
        untraced = [ms for i, ms in enumerate(step_ms)
                    if not first <= i < first + k + TRACE_AFTER]
        record = RunRecord(cell, steps, run.spans, summary, e2e, untraced,
                           getattr(run.ref, cell.config["flops"])(
                               int(run.cfg["dataset"]["transformer"]["image_size"]),
                               int(run.cfg["model"]["num_classes"])),
                           getattr(run.ref, "KERNEL_WORK", {}), cell.chips, prof)
        reported = {}
        for m in catalog.cell_metrics(cell, "per_layer"):
            value = catalog.load_metric(m["name"], cell.root).read(record)
            if value is not None:
                reported[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        reported = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                    for m in catalog.cell_metrics(cell, "end_to_end")}
    device_info = {"platform": "gpu" if dev.type == "cuda" else "cpu",
                   "kind": info["device"], "count": world, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(ok and counted), "attempted": steps * cell.global_batch,
              "failed": steps * cell.global_batch - int(count),
              "metrics": reported, "device": device_info}
    if summary is not None:
        device_info.update(busy_s=summary.busy_s, window_s=summary.window_s)
        result["breakdown"] = trace.breakdown(summary)
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in rows}
    refuse_forbidden()
    return result


class ForbiddenModules(RuntimeError):
    def __init__(self, names):
        super().__init__(f"modules that the benchmark may not load: {', '.join(names)}")


def _built_kernels():
    from hawkeye_tpu_torch.ops import _build

    return _build.BUILD_LOG.keys()
