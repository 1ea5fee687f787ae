"""The traced stretch of a window and its reduction to per-layer numbers.

``Profile`` runs ``torch.profiler`` (CPU and CUDA activity) over a stretch
of the window's steps and keeps its host length. ``summarize`` reduces it:

* each device activity (kernel, copy, set) by name: time and count;
* categories: a frozen copy of ``hawkeye_tpu_torch/profile_step.py``'s
  ``_category`` (by kernel name) and ``_launch_category`` (by the host op or
  range that launched it: what runs under the benchmark's
  ``portbench::augment`` range is ``augmentation``, under
  ``Optimizer.step`` ``optimizer``), with two additions: NCCL kernels are
  ``collective`` and copies and sets ``memory``, where the original (whose
  inputs sat on the device, on one card) had none of either;
* busy time: the union of the device intervals over all streams, so that
  NCCL's stream overlapping the compute stream counts once;
* idle gaps: the stretches between those intervals, each named by the
  benchmark span (``data_wait``, ``prepare_batch``, ``train_step_call``, or
  ``other``) that the host was in at the gap's middle.
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field

import torch

PORTED = {"pool_fwd_kernel": "pool_fwd", "pool_bwd_kernel": "pool_bwd",
          "gram_signed_sqrt": "gram_signed_sqrt"}
AUGMENT = "portbench::augment"
HOST_SPANS = ("portbench::data_wait", "portbench::prepare_batch",
              "portbench::train_step_call")


def category(name: str) -> str:
    low = name.lower()
    for key, cat in PORTED.items():
        if key in name:
            return cat
    if "nccl" in low:
        return "collective"
    if low.startswith(("memcpy", "memset")):
        return "memory"
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


def launch_category(event):
    """The category that the launching host op, or one above it, sets."""
    while event is not None:
        if event.name == AUGMENT:
            return "augmentation"
        if event.name.startswith("Optimizer.step"):
            return "optimizer"
        event = event.cpu_parent
    return None


class Profile:
    def __init__(self, device):
        self.device = device
        self.prof = None
        self.t0 = self.window_s = None

    def start(self):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.window_s = time.perf_counter() - self.t0
        self.prof.stop()


@dataclass
class Summary:
    steps: int
    window_s: float
    busy_s: float = 0.0
    kernels: dict = field(default_factory=dict)  # name -> [seconds, count]
    categories: dict = field(default_factory=dict)  # name -> seconds
    gaps: list = field(default_factory=list)  # [(seconds, host span)]

    def ms_per_step(self, cat):
        return self.categories.get(cat, 0.0) * 1e3 / self.steps

    def kernel_time(self, substring):
        """(seconds, launches) of the kernels whose name holds ``substring``."""
        s = n = 0
        for name, (t, c) in self.kernels.items():
            if substring in name:
                s, n = s + t, n + c
        return s, n


def _is_device(e):
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.name != "Command Buffer Full")


def merge(intervals):
    """Union of (start, end) intervals, sorted."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize(events, steps, window_s):
    """Reduce the profiler's events (``profile.events()``) of ``steps``
    steps traced over ``window_s`` host seconds. Times in the events are in
    microseconds."""
    s = Summary(steps=steps, window_s=window_s)
    intervals, spans = [], []
    host_start = host_end = None
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if _is_device(e):
            intervals.append((a, b))
            entry = s.kernels.setdefault(e.name, [0.0, 0])
            entry[0] += (b - a) / 1e6
            entry[1] += 1
            c = category(e.name)
            s.categories[c] = s.categories.get(c, 0.0) + (b - a) / 1e6
            continue
        host_start = a if host_start is None else min(host_start, a)
        host_end = b if host_end is None else max(host_end, b)
        if e.name in HOST_SPANS:
            spans.append((a, b, e.name[len("portbench::"):]))
            continue
        c = launch_category(e)
        if c is None or e.name.startswith("cu"):
            continue
        for k in e.kernels:  # move what this op launched to its category
            d = k.duration / 1e6
            s.categories[c] = s.categories.get(c, 0.0) + d
            base = category(k.name)
            s.categories[base] = s.categories.get(base, 0.0) - d
    busy = merge(intervals)
    s.busy_s = sum(b - a for a, b in busy) / 1e6
    spans.sort()
    starts = [a for a, _, _ in spans]
    edges = [host_start] + [x for ab in busy for x in ab] + [host_end]
    for a, b in zip(edges[::2], edges[1::2]):
        if a is None or b is None or b <= a:
            continue
        mid = (a + b) / 2
        i = bisect.bisect_right(starts, mid) - 1  # the host spans are disjoint
        name = spans[i][2] if i >= 0 and mid < spans[i][1] else "other"
        s.gaps.append(((b - a) / 1e6, name))
    s.gaps.sort(reverse=True)
    return s


def breakdown(summary):
    """The result line's ``breakdown``: the categories that took most device
    time, and the idle time by host span (total, then the longest gaps)."""
    ops = sorted(((k, v) for k, v in summary.categories.items() if v > 0),
                 key=lambda kv: -kv[1])[:10]
    totals = {}
    for t, name in summary.gaps:
        n, tot = totals.get(name, (0, 0.0))
        totals[name] = (n + 1, tot + t)
    idle = [[f"{name}: {n} gaps", tot] for name, (n, tot) in
            sorted(totals.items(), key=lambda kv: -kv[1][1])]
    idle += [[f"{name}: one gap", t] for t, name in summary.gaps[:10 - len(idle)]]
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": idle[:10]}
