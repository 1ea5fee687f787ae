"""Optimizers and LR schedules.

Counterpart of ``hawkeye_tpu/engine/optim.py``. The reference builds torch
optimizers from ``config.train.optimizer`` (``train.py:185-198``):
SGD/Adam(W) with momentum/weight_decay, plus per-Example parameter groups
with constant LR ratios. Here that is ``torch.optim`` directly: SGD with
coupled L2 (``weight_decay``) and momentum/nesterov is what the JAX package
builds as ``add_decayed_weights`` + ``trace``; Adam is coupled L2, AdamW
decoupled. A parameter group may carry an ``lr_mult``; ``set_learning_rate``
writes ``lr * lr_mult`` into every group; ``prefix_param_groups`` builds
such groups from name prefixes, as ``make_prefix_labeler`` labels the JAX
parameters (``Examples/MPN.py``). The schedulers are host-side and
copied as they are: the trainer asks them for a rate each epoch.
"""

from __future__ import annotations

import math

import torch


# --------------------------------------------------------------------------
# optimizer factory
# --------------------------------------------------------------------------
def _groups(params):
    params = list(params)
    if params and isinstance(params[0], dict):
        return [dict(g, lr_mult=float(g.get("lr_mult", 1.0))) for g in params]
    return [{"params": params, "lr_mult": 1.0}]


def build_optimizer(opt_config, params):
    """Build the ``torch.optim`` optimizer.

    Args:
      opt_config: config node with ``name``, ``lr`` and optional
        momentum/nesterov/weight_decay/beta1/beta2/eps.
      params: an iterable of parameters, or of group dicts
        ``{"params": [...], "lr_mult": m}``.

    Returns (optimizer, base_lr).
    """
    base_lr = float(opt_config.lr)
    wd = float(opt_config.get("weight_decay", 0.0))
    groups = _groups(params)
    for g in groups:
        g["lr"] = base_lr * g["lr_mult"]
    name = opt_config.name.lower()
    if name == "sgd":
        momentum = float(opt_config.get("momentum", 0.0))
        opt = torch.optim.SGD(groups, lr=base_lr, momentum=momentum,
                              weight_decay=wd,
                              nesterov=bool(opt_config.get("nesterov", False)))
    elif name in ("adam", "adamw"):
        cls = torch.optim.Adam if name == "adam" else torch.optim.AdamW
        opt = cls(groups, lr=base_lr,
                  betas=(float(opt_config.get("beta1", 0.9)),
                         float(opt_config.get("beta2", 0.999))),
                  eps=float(opt_config.get("eps", 1e-8)), weight_decay=wd)
    else:
        raise ValueError(f"unknown optimizer {opt_config.name!r}")
    return opt, base_lr


def prefix_param_groups(module, rules, multipliers, default="head"):
    """Parameter groups by name prefix: the counterpart of the JAX package's
    ``make_prefix_labeler`` with its ``{label: multiplier}`` map.

    A parameter whose dot-joined name is a key of ``rules`` or starts with
    one followed by a dot gets that rule's label (``backbone`` matches
    ``backbone.x``, not ``backbone2.x``; the first matching rule wins),
    every other parameter ``default``. Returns one group
    ``{"params": [...], "lr_mult": m}`` per label of ``multipliers`` that
    holds a parameter, so each parameter is in exactly one group."""
    params = {label: [] for label in multipliers}
    for name, p in module.named_parameters():
        label = next((lab for prefix, lab in rules.items()
                      if name == prefix or name.startswith(prefix + ".")),
                     default)
        if label not in params:
            raise KeyError(f"parameter {name} has label {label!r}, which has "
                           f"no multiplier in {sorted(multipliers)}")
        params[label].append(p)
    return [{"params": ps, "lr_mult": float(multipliers[label]), "label": label}
            for label, ps in params.items() if ps]


def set_learning_rate(optimizer, lr):
    """Write a new base LR into every group (times its ``lr_mult``)."""
    for g in optimizer.param_groups:
        g["lr"] = float(lr) * g.get("lr_mult", 1.0)
    return optimizer


# --------------------------------------------------------------------------
# schedulers (host-side, epoch-granular unless noted)
# --------------------------------------------------------------------------
class LRScheduler:
    """Base: constant LR."""

    def __init__(self, base_lr):
        self.base_lr = float(base_lr)
        self.current_lr = float(base_lr)

    def epoch_lr(self, epoch: int) -> float:
        return self.current_lr

    def step_metric(self, metric: float):
        """Called once per epoch with the validation metric (plateau only)."""

    def state_dict(self):
        return {"current_lr": self.current_lr}

    def load_state_dict(self, d):
        self.current_lr = d.get("current_lr", self.base_lr)


class CosineAnnealingLR(LRScheduler):
    """Cosine annealing with optional linear warmup (the reference composes
    LinearLR(start_factor=lr_warmup_decay) + CosineAnnealingLR via
    SequentialLR, ``Examples/MPN.py:22-31``)."""

    def __init__(self, base_lr, T_max, eta_min=0.0, warmup_epochs=0,
                 warmup_decay=0.01):
        super().__init__(base_lr)
        self.T_max = int(T_max)
        self.eta_min = float(eta_min)
        self.warmup_epochs = int(warmup_epochs)
        self.warmup_decay = float(warmup_decay)

    def epoch_lr(self, epoch):
        if self.warmup_epochs and epoch < self.warmup_epochs:
            # torch LinearLR: factor goes start_factor -> 1 over total_iters
            f = self.warmup_decay + (1.0 - self.warmup_decay) * (
                epoch / self.warmup_epochs)
            self.current_lr = self.base_lr * f
        else:
            e = min(epoch - self.warmup_epochs, self.T_max)
            t = max(self.T_max - self.warmup_epochs, 1)
            self.current_lr = self.eta_min + 0.5 * (self.base_lr - self.eta_min) * (
                1 + math.cos(math.pi * e / t))
        return self.current_lr


class StepLR(LRScheduler):
    def __init__(self, base_lr, step_size, gamma=0.1):
        super().__init__(base_lr)
        self.step_size = int(step_size)
        self.gamma = float(gamma)

    def epoch_lr(self, epoch):
        self.current_lr = self.base_lr * self.gamma ** (epoch // self.step_size)
        return self.current_lr


class MultiStepLR(LRScheduler):
    def __init__(self, base_lr, milestones, gamma=0.1):
        super().__init__(base_lr)
        self.milestones = sorted(int(m) for m in milestones)
        self.gamma = float(gamma)

    def epoch_lr(self, epoch):
        k = sum(1 for m in self.milestones if epoch >= m)
        self.current_lr = self.base_lr * self.gamma ** k
        return self.current_lr


class ReduceLROnPlateau(LRScheduler):
    """torch semantics (mode='max' on val accuracy, reference BCNN usage)."""

    def __init__(self, base_lr, mode="max", factor=0.1, patience=10,
                 threshold=1e-4, min_lr=0.0):
        super().__init__(base_lr)
        self.mode = mode
        self.factor = float(factor)
        self.patience = int(patience)
        self.threshold = float(threshold)
        self.min_lr = float(min_lr)
        self.best = None
        self.num_bad = 0

    def _is_better(self, metric):
        if self.best is None:
            return True
        if self.mode == "max":
            return metric > self.best * (1 + self.threshold)
        return metric < self.best * (1 - self.threshold)

    def step_metric(self, metric):
        if self._is_better(metric):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.current_lr = max(self.current_lr * self.factor, self.min_lr)
                self.num_bad = 0

    def state_dict(self):
        return {"current_lr": self.current_lr, "best": self.best,
                "num_bad": self.num_bad}

    def load_state_dict(self, d):
        super().load_state_dict(d)
        self.best = d.get("best")
        self.num_bad = d.get("num_bad", 0)


def build_scheduler(sched_config, base_lr) -> LRScheduler:
    """Config → scheduler (reference scheduler names, ``train.py:200-218``)."""
    if sched_config is None:
        return LRScheduler(base_lr)
    name = sched_config.get("name")
    if name in (None, "", "None", "none", "Constant"):
        # several reference recipes omit the scheduler name but provide
        # T_max/warmup fields and build warmup+cosine in their Example
        # (e.g. CBCNN_S2, Examples/MPN.py:20-31)
        if "T_max" in sched_config:
            name = "WarmupCosine"
        else:
            return LRScheduler(base_lr)
    if name in ("CosineAnnealingLR", "WarmupCosine"):
        return CosineAnnealingLR(
            base_lr, T_max=sched_config.get("T_max", 30),
            eta_min=sched_config.get("eta_min", 0.0),
            warmup_epochs=sched_config.get("warmup_epochs", 0),
            warmup_decay=sched_config.get("lr_warmup_decay", 0.01))
    if name == "StepLR":
        return StepLR(base_lr, sched_config.step_size,
                      sched_config.get("gamma", 0.1))
    if name == "MultiStepLR":
        return MultiStepLR(base_lr, sched_config.milestones,
                           sched_config.get("gamma", 0.1))
    if name == "ReduceLROnPlateau":
        return ReduceLROnPlateau(
            base_lr, mode=sched_config.get("mode", "max"),
            factor=sched_config.get("factor", 0.1),
            patience=sched_config.get("patience", 10),
            min_lr=sched_config.get("min_lr", 0.0))
    raise ValueError(f"unknown scheduler {name!r}")
