"""A copy of the benchmark's folder at a size the CPU runs in seconds: the
configurations at 32x32 (decodes 36x36) and 10 classes, batches of 4 from a
pool of 2 batches, two warm-up steps; every file otherwise as it is."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import yaml

from portbench import catalog

IMAGE, DECODE, CLASSES, BATCH = 32, 36, 10, 4


def tiny_bench(tmp, ranks=1):
    """``tmp/portbench`` beside ``tmp/BENCHMARK.json``; returns the folder."""
    src = catalog.HERE
    dst = Path(tmp) / "portbench"
    for sub in ("configs", "traffic", "workloads", "metrics", "reference"):
        shutil.copytree(src / sub, dst / sub, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(src.parent / "BENCHMARK.json", Path(tmp) / "BENCHMARK.json")
    for path in (dst / "configs").glob("*.yaml"):
        cfg = yaml.safe_load(path.read_text())
        cfg["run"]["dataset"]["transformer"].update(image_size=IMAGE, resize_size=DECODE)
        cfg["run"]["dataset"]["num_workers"] = 1
        cfg["run"]["model"]["num_classes"] = CLASSES
        path.write_text(yaml.safe_dump(cfg))
    for path in (dst / "traffic").glob("*.json"):
        t = json.loads(path.read_text())
        t.update(batch_per_rank=BATCH, pool_batches=2, warmup_steps=2)
        path.write_text(json.dumps(t))
    return dst


def set_limits(root, cell, limits):
    path = Path(root) / "workloads" / f"{cell}.json"
    spec = json.loads(path.read_text())
    spec["limits"] = limits
    path.write_text(json.dumps(spec))


def float32_port(trainer):
    """The port's trunk and augmentation in float32 (its bfloat16 is the
    configuration's; at a tiny size the comparison wants no rounding)."""
    import torch

    from hawkeye_tpu_torch.data.transforms_device import make_train_augment

    for m in trainer.model.modules():
        if isinstance(getattr(m, "dtype", None), torch.dtype):
            m.dtype = torch.float32
    trainer.device_augment = make_train_augment(
        IMAGE, erase_prob=0.1, auto_augment="ta_wide", compute_dtype=torch.float32)


def break_step(trainer, fault):
    """Break the timed path underneath the harness: ``state_unchanged``
    (the update skipped), ``half_batch`` (the loss over the first half of
    the rows), ``label_altered`` (one label changed where the batch is
    made), ``no_exchange`` (no gradient average and no cross-rank BatchNorm
    statistics)."""
    if fault == "state_unchanged":
        trainer.optimizer.step = lambda *a, **k: None
    elif fault == "half_batch":
        criterion = trainer.criterion

        def half(outputs, batch):
            h = batch["label"].shape[0] // 2
            return criterion({"logits": outputs["logits"][:h]},
                             {k: v[:h] for k, v in batch.items()})

        trainer.criterion = half
    elif fault == "label_altered":
        prepare = trainer.prepare_batch

        def altered(batch, train):
            out = prepare(batch, train)
            out["label"][0] = (out["label"][0] + 1) % CLASSES
            return out

        trainer.prepare_batch = altered
    elif fault == "no_exchange":
        import hawkeye_tpu_torch.engine.trainer as tr
        from hawkeye_tpu_torch.models.backbones.norm import set_cross_replica

        tr.average_gradients = lambda params: None
        set_cross_replica(trainer.model, False)
    elif fault is not None:
        raise ValueError(fault)


def patched_instrument(fault=None):
    """``probe.instrument`` that first puts the port in float32 and plants
    ``fault``."""
    from portbench import probe

    orig = probe.instrument

    def instrument(trainer, spans):
        float32_port(trainer)
        break_step(trainer, fault)
        return orig(trainer, spans)

    return instrument
