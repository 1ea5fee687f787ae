"""The port's own spans and counters, recorded while a ``torch.profiler``
records and at no other time.

Off (no profiler recording), a site costs one read of torch's profiler
flag: ``span`` hands back one shared no-op context, and nothing is timed,
hooked, ranged or allocated. On, ``span(name)`` is the profiler range
``hk::<name>``, so the span sits on the profiler's clock beside the work
it launched (in a Chrome trace of ``experiment.profile`` and in the
benchmark's trace). The tracer itself keeps only the counters, the count
of traced steps and the names of the spans with a backward;
``summary(events)`` reads the spans back out of the profiler's events, the
backward of a span too, so nothing runs in the backward pass.

The spans and counters, and who reads them (the benchmark's per-layer
metrics under ``portbench/metrics/``, ``profile_step``'s categories, the
Trainer's ``experiment.profile`` log line):

* ``data.wait`` (``data/loader.py``): the main thread getting a batch's
  items (waiting on the decode threads' futures) -- ``item_wait_ms``;
* ``data.collate``: the ``collate_fn`` call on the main thread --
  ``collate_ms``;
* ``pin`` (``Trainer.prepare_batch``): the host arrays wrapped, pinned and
  their copies to the device enqueued -- ``pin_ms``;
* ``augment`` (``Trainer.device_prepare_train``): the call of
  ``device_augment`` -- ``profile_step``'s ``augmentation``;
* ``forward``, ``backward`` (``Trainer.train_step_call``): ``forward_train``
  (model and criterion) and ``loss.backward()`` -- ``forward_ms``,
  ``backward_ms``;
* ``batch_norm``, ``batch_norm.backward`` (``models/backbones/norm.py``
  ``batch_norm_train``, every train-mode normalisation): the layer's
  forward without the running-statistics fold, and the backward of its
  ops -- ``norm_ms``;
* ``allreduce.bn_stats`` (``_AllReduceSum``, forward and backward) and
  ``allreduce.grads`` (``parallel/mesh.py`` ``average_gradients``) --
  ``bn_allreduce_ms``, ``grad_allreduce_ms``;
* ``nms``, ``roi_crop``, ``saliency``, ``warp``, ``cam_crop`` (NTS-Net,
  AP-CNN, S3N and MGE-CNN's region steps) -- ``profile_step``'s categories
  of those names;
* counters ``collective.calls`` and ``collective.bytes``
  (``parallel/mesh.py`` ``all_reduce_sum``, which every all-reduce of a
  step goes through) -- ``collective_calls``, ``collective_mb``.

``step()`` counts the traced steps (``Trainer.train_step_call`` calls it
once) and ``reset()`` drops the counts. The state is the process's: the
sites sit deep in the models and the loader, which no caller could hand
an object to.
"""

from __future__ import annotations

import bisect
import functools
from collections import defaultdict

import torch
from torch._C._profiler import RecordScope
from torch.autograd import DeviceType
from torch.autograd import profiler as _profiler

PREFIX = "hk::"


def enabled():
    """Whether a ``torch.profiler`` is recording (torch's own flag)."""
    return _profiler._is_profiler_enabled


class _Off:
    """The shared context of every site while no profiler records."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name, backward=False):
    """The profiler range ``hk::<name>`` while a profiler records; else the
    shared no-op context. With ``backward``, ``summary`` reads the backward
    of the ops run inside it as the span ``<name>.backward`` too."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    if backward:
        _backward.add(name)
    return torch.profiler.record_function(PREFIX + name)


def spanned(name):
    """Decorate a function so that each of its calls is the span ``name``."""

    def wrap(fn):
        @functools.wraps(fn)
        def traced(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return traced

    return wrap


_counters = defaultdict(int)
_steps = 0
_backward = set()  # the spans opened with ``backward``


def count(name, n=1):
    """Add ``n`` to the counter ``name`` while a profiler records."""
    if _profiler._is_profiler_enabled:
        _counters[name] += n


def step():
    """One traced step begins (a no-op while no profiler records)."""
    global _steps
    if _profiler._is_profiler_enabled:
        _steps += 1


EVALUATE = "autograd::engine::evaluate_function: "  # a backward node's range
_NODE = int(RecordScope.BACKWARD_FUNCTION)  # the scope of a node's own record


def ranges(events):
    """The spans in ``events``, a stopped profiler's ``events()``, as
    ``(start, end, name, call)`` in microseconds (a call's key in ``call``).

    Each ``hk::`` range is one call. A span opened with ``backward`` adds,
    as one call of ``<name>.backward``, the autograd nodes of the ops run
    inside it: the profiler gives an op that records autograd the number of
    the next node (ops that make none share it with the next that does), and
    a node's range carries that number and its forward's thread, so a
    node's op is the last one with that number on that thread (the node's
    own record, which carries it too, left out). The backward is read off
    the profiler's records and registers nothing."""
    spans, forward, nodes = [], {}, []
    for e in events:
        if e.device_type != DeviceType.CPU:
            continue
        a = e.time_range.start
        if e.name.startswith(PREFIX):
            spans.append((a, e.time_range.end, e.name[len(PREFIX):], e.thread))
        elif e.name.startswith(EVALUATE):
            if e.sequence_nr >= 0:
                nodes.append((a, e.time_range.end, e.fwd_thread, e.sequence_nr))
        elif (e.sequence_nr >= 0 and e.scope != _NODE
              and a >= forward.get((e.thread, e.sequence_nr), a)):
            forward[e.thread, e.sequence_nr] = a
    out = [(a, b, name, (a, thread)) for a, b, name, thread in spans]
    opened = {}  # thread -> (starts, spans) of the spans with a backward
    for a, b, name, thread in sorted(s for s in spans if s[2] in _backward):
        starts, kept = opened.setdefault(thread, ([], []))
        starts.append(a)
        kept.append((a, b, name))
    for a, b, thread, seq in nodes:
        t = forward.get((thread, seq))
        starts, kept = opened.get(thread, ((), ()))
        i = bisect.bisect_right(starts, t) - 1 if t is not None else -1
        if i >= 0 and t <= kept[i][1]:
            out.append((a, b, kept[i][2] + ".backward", (kept[i][0], thread)))
    return out


def summary(events=()):
    """``{"steps": traced steps, "spans": {name: {"calls", "host_ms",
    "device_ms"}}, "counters": {name: total}}`` since the last ``reset``.

    The spans are ``ranges(events)``: a span's calls and host ms are its
    calls and their ranges' length; its device ms is the device time of the
    work launched while one of its ranges was open, on any thread (the
    backward's ops run on the autograd engine's), so a collective's time
    holds its wait for the peers and a span's time no gap between its
    launches. ``device_ms`` is None where the events hold no device
    activity."""
    events = list(events)
    launches, on_device = [], False
    for e in events:
        if e.device_type != DeviceType.CPU:
            on_device = on_device or not getattr(e, "is_user_annotation", False)
        elif e.kernels and not e.name.startswith("cu"):  # the op that launched them
            launches.append((e.time_range.start, sum(k.duration for k in e.kernels)))
    spans = sorted(ranges(events))
    out, calls = {}, defaultdict(set)
    for a, b, name, call in spans:
        row = out.setdefault(name, {"calls": 0, "host_ms": 0.0,
                                    "device_ms": 0.0 if on_device else None})
        calls[name].add(call)
        row["calls"] = len(calls[name])
        row["host_ms"] += (b - a) / 1e3
    if on_device:  # sweep the launches in time, with the spans open at each
        launches.sort()
        open_, i = [], 0
        for t, us in launches:
            while i < len(spans) and spans[i][0] <= t:
                open_.append(spans[i])
                i += 1
            open_ = [r for r in open_ if r[1] >= t]
            for name in {r[2] for r in open_}:
                out[name]["device_ms"] += us / 1e3
    return {"steps": _steps, "spans": out, "counters": dict(_counters)}


def describe(summ):
    """One log line of a ``summary()``: each span's calls, host ms and
    device ms a traced step, then the counters a step."""
    n = max(summ["steps"], 1)
    parts = []
    for name, row in sorted(summ["spans"].items()):
        dev = "" if row["device_ms"] is None else f", device {row['device_ms'] / n:.3f} ms"
        parts.append(f"{name} {row['calls'] / n:g}/step, host {row['host_ms'] / n:.3f} ms{dev}")
    counters = "; ".join(f"{k} {v / n:g}/step" for k, v in sorted(summ["counters"].items()))
    return (f"spans a step over {summ['steps']} traced steps: " + "; ".join(parts)
            + (f" | counters a step: {counters}" if counters else ""))


def reset():
    """Drop the counters, the step count and the spans with a backward."""
    global _steps
    _counters.clear()
    _backward.clear()
    _steps = 0
