"""Spans, step clocks and hooks that the benchmark puts around the port's
calls, from its own files; the program is not edited.

* Host spans (``perf_counter_ns``, kept in memory) around the loader
  iterator's ``__next__`` (``data_wait``), ``Trainer.prepare_batch``,
  ``Trainer.train_step_call`` and ``Trainer.device_augment``; in a traced
  run each is a profiler range ``portbench::<name>`` as well.
* A CUDA event recorded at each ``on_end_batch``, with no sync: the step
  clock of the window.
* The check's readings of the first steps: each step's loss, the first
  gradient worked out from the optimizer's state after step 1, and the
  parameters' change after the last checked step (per-leaf norms).
"""

from __future__ import annotations

import time
from collections import defaultdict

import torch

RANGE = "portbench::"


class Spans:
    def __init__(self, ranged=False):
        self.calls = defaultdict(list)  # name -> [(start_ns, end_ns)]
        self.ranged = ranged

    def wrap(self, fn, name):
        calls = self.calls[name]
        label = RANGE + name

        def timed(*args, **kwargs):
            t0 = time.perf_counter_ns()
            if self.ranged:
                with torch.profiler.record_function(label):
                    out = fn(*args, **kwargs)
            else:
                out = fn(*args, **kwargs)
            calls.append((t0, time.perf_counter_ns()))
            return out

        return timed

    def clear(self):
        for v in self.calls.values():
            v.clear()

    def mean_ms(self, name, steps):
        calls = self.calls.get(name, [])
        return sum(b - a for a, b in calls) / 1e6 / steps if calls and steps else None


class TimedLoader:
    """The port's loader, its iterator's ``__next__`` under the span
    ``data_wait``."""

    def __init__(self, loader, spans):
        self.loader = loader
        self.next_batch = spans.wrap(next, "data_wait")

    def __iter__(self):
        it = iter(self.loader)
        while True:
            try:
                yield self.next_batch(it)
            except StopIteration:
                return

    def __len__(self):
        return len(self.loader)

    def set_epoch(self, epoch):
        self.loader.set_epoch(epoch)


class StepClock:
    """The ends of the window's steps: CUDA events on the card, the host
    clock on the CPU (tests)."""

    def __init__(self, device, steps):
        self.cuda = device.type == "cuda"
        n = steps + 1
        self.marks = ([torch.cuda.Event(enable_timing=True) for _ in range(n)]
                      if self.cuda else [0.0] * n)
        self.i = 0

    def mark(self):
        if self.cuda:
            self.marks[self.i].record()
        else:
            self.marks[self.i] = time.perf_counter()
        self.i += 1

    def intervals_ms(self):
        """Each step's length; call after the device has finished."""
        m = self.marks[:self.i]
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(m, m[1:])]
        return [(b - a) * 1e3 for a, b in zip(m, m[1:])]


def _first_grad(optimizer, p, p0):
    """The gradient that step 1 fed ``optimizer``, worked out from its state
    after that step and the parameter before it."""
    group = next(g for g in optimizer.param_groups if any(q is p for q in g["params"]))
    state = optimizer.state.get(p, {})
    if not state:  # a step that left the optimizer as it was
        return torch.zeros_like(p)
    wd = group.get("weight_decay", 0.0)
    if isinstance(optimizer, torch.optim.SGD):
        return state["momentum_buffer"] - wd * p0
    if isinstance(optimizer, torch.optim.AdamW):
        return state["exp_avg"] / (1.0 - group["betas"][0])
    if isinstance(optimizer, torch.optim.Adam):
        return state["exp_avg"] / (1.0 - group["betas"][0]) - wd * p0
    raise TypeError(f"no rule for the first gradient of {type(optimizer).__name__}")


def _norms(tensors):
    return {k: torch.linalg.vector_norm(t.double()) for k, t in tensors.items()}


class Probe:
    """The hooks' state across the check, the warm-up and the window."""

    def __init__(self, trainer, spans):
        self.trainer = trainer
        self.spans = spans
        self.phase = None
        self.n = 0
        self.clock = None
        self.profile = None  # (first step, steps, Profile) in a traced run
        self.losses = []
        self.grad_norms = None
        self.p0 = None

    def begin(self, phase, clock=None, profile=None):
        self.phase, self.n, self.clock, self.profile = phase, 0, clock, profile
        if phase == "check":
            self.p0 = {k: p.detach().clone()
                       for k, p in self.trainer.model.named_parameters()}
        if clock is not None:
            clock.mark()  # the window's start

    def end_batch(self, metrics):
        self.n += 1
        if self.clock is not None:
            self.clock.mark()
        if self.phase == "check":
            self.losses.append(metrics["loss"].detach())
            if self.n == 1:
                opt = self.trainer.optimizer
                self.grad_norms = _norms({
                    k: _first_grad(opt, p, self.p0[k])
                    for k, p in self.trainer.model.named_parameters()})
        if self.profile is not None:
            first, steps, prof = self.profile
            if self.n == first:
                prof.start()
            elif self.n == first + steps:
                prof.stop()

    def check_readings(self):
        """Losses, first-gradient and change norms of the checked steps."""
        change = _norms({k: p.detach() - self.p0[k]
                         for k, p in self.trainer.model.named_parameters()})
        out = {"losses": [float(x) for x in self.losses],
               "grad_norms": {k: float(v) for k, v in self.grad_norms.items()},
               "change_norms": {k: float(v) for k, v in change.items()}}
        self.p0 = None
        return out


def bench_trainer_class(base, dataset, sampler):
    """``base`` (an Example trainer) reading the benchmark's pool through
    its own ``get_dataloader``, with the probe's hooks."""

    class BenchTrainer(base):
        probe = None

        def get_dataset(self, ds_config):
            return {"train": dataset}

        def get_sampler(self, split, ds_config):
            return sampler

        def on_end_batch(self, metrics):
            if self.probe is not None:
                self.probe.end_batch(metrics)

    BenchTrainer.__name__ = f"Bench{base.__name__}"
    return BenchTrainer


def instrument(trainer, spans):
    """Put the spans around the trainer's layers; return its probe."""
    trainer.dataloaders["train"] = TimedLoader(trainer.dataloaders["train"], spans)
    trainer.prepare_batch = spans.wrap(trainer.prepare_batch, "prepare_batch")
    trainer.train_step_call = spans.wrap(trainer.train_step_call, "train_step_call")
    if getattr(trainer, "device_augment", None) is not None:
        trainer.device_augment = spans.wrap(trainer.device_augment, "augment")
    trainer.probe = Probe(trainer, spans)
    return trainer.probe

