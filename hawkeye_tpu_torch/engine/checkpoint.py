"""Checkpoint save/load, in the port's own format (``torch.save`` of state
dicts, extension ``.pt``).

Reference semantics kept from ``hawkeye_tpu/engine/checkpoint.py``
(``train.py:369-395``):

- ``save_model``: weights only (``model_epoch_N`` / ``best_model``), loadable
  into a *fresh* model via ``config.model.load``; two-stage recipes
  (``configs/BCNN_S2.yaml``) load the stage-1 best model this way.
- ``save_checkpoint``: full state {epoch, model, optimizer, scheduler, step}
  for ``experiment.resume``.
- ``emergency_save`` (``engine/trainer.py``): on a crash or interrupt, write
  the full checkpoint.

The recipes in ``configs/`` name the JAX package's ``.msgpack`` files; a
``.msgpack`` path given to ``load_model`` or ``load_checkpoint`` reads the
``.pt`` file of the same stem, which is what this package writes in its
place. Writes go to a temporary file first and are renamed into place.
"""

from __future__ import annotations

import os

import torch


def port_path(path: str) -> str:
    """The file this package reads/writes for ``path``."""
    root, ext = os.path.splitext(path)
    return root + ".pt" if ext == ".msgpack" else path


def _atomic_save(obj, path):
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _cpu_state(module):
    return {k: v.detach().cpu() for k, v in module.state_dict().items()}


def save_model(path, model):
    """Weights-only save of ``model.state_dict()``."""
    _atomic_save(_cpu_state(model), port_path(path))


@torch.no_grad()
def partial_load(module, state, prefix="", logger=None):
    """Copy the tensors of ``state`` whose name (under ``prefix``) and shape
    match ``module``'s state dict, keep the rest of the module as it is
    (reference ``model/utils.py:28-33``), and report, as the JAX package's
    ``merge_into`` does, how many were loaded and which of ``state``'s were
    missing from the module or shape-mismatched."""
    own = module.state_dict()
    report = {"loaded": 0, "skipped_missing": [], "skipped_shape": []}
    for k, v in state.items():
        name = prefix + k
        if name not in own:
            report["skipped_missing"].append(name)
        elif tuple(own[name].shape) != tuple(v.shape):
            report["skipped_shape"].append(
                f"{name}: {tuple(own[name].shape)} vs {tuple(v.shape)}")
        else:
            own[name].copy_(v)
            report["loaded"] += 1
    if logger is not None:
        logger.info(
            f"partial load: {report['loaded']} tensors loaded, "
            f"{len(report['skipped_missing'])} missing, "
            f"{len(report['skipped_shape'])} shape-mismatched")
        for s in report["skipped_shape"]:
            logger.info(f"  shape mismatch: {s}")
    return report


def load_model(path, model, logger=None):
    """Shape-checked partial load (``partial_load``) of a weights-only file
    into ``model``; returns the report."""
    state = torch.load(port_path(path), map_location="cpu", weights_only=True)
    return partial_load(model, state, logger=logger)


def save_checkpoint(path, *, epoch, model, optimizer, scheduler_state=None,
                    extra=None):
    """Full training state (model + optimizer + scheduler + counters)."""
    _atomic_save({
        "epoch": int(epoch),
        "model": _cpu_state(model),
        "optimizer": optimizer.state_dict(),
        "scheduler": scheduler_state or {},
        "extra": extra or {},
    }, port_path(path))


def load_checkpoint(path, *, model, optimizer, device):
    """Restore a checkpoint written by ``save_checkpoint`` into ``model`` and
    ``optimizer``. Returns (epoch, scheduler_state, extra)."""
    raw = torch.load(port_path(path), map_location=device, weights_only=True)
    model.load_state_dict(raw["model"])
    optimizer.load_state_dict(raw["optimizer"])
    return int(raw["epoch"]), raw["scheduler"], raw["extra"]
