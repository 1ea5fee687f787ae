"""Trainer runtime.

Counterpart of ``hawkeye_tpu/engine/trainer.py``, with the same lifecycle
and override surface (reference ``train.py:41-439``): log-dir creation and
config/entry-script snapshot, logger and TensorBoard, seeding, the
data/model/criterion/optimizer/scheduler factories (``get_*``), the epoch
loop with ``val_first``, best-model tracking (epoch >= 5 gate), periodic
``save_model`` by ``save_frequence``, checkpoint/resume, emergency save on a
crash, the images/sec log line and the epoch/batch hooks. Subclasses override
``forward_train``/``forward_eval``/``compute_metrics`` as in the JAX package.

PyTorch design: one eager train step (``train_step_call``) on one device.
The device is CUDA unless the caller passes ``device="cpu"``; asking for
CUDA where there is none raises. Metrics stay on the device and are read
once per epoch. TF32 is off for both cuDNN and cuBLAS, so float32 convs and
matmuls are full float32, as in the JAX reference on the CPU.

Stage-1 hazard: the JAX optimizer moves every parameter each step, frozen
ones included (``g = 0 + wd*p`` feeds the momentum), while ``torch.optim``
skips a parameter whose ``.grad`` is None. ``train_step_call`` therefore
gives every parameter without a gradient a zero one before the update.

TPU mechanisms that do not come across, with their config keys still read
and ignored: the device mesh and batch padding to a device multiple,
``train.steps_per_dispatch``, ``train.remat``, ``train.async_checkpoint``.
Validation needs no padding: each batch's loss is its mean over its real
samples and the epoch's loss the mean over batches, as the JAX trainer's
weight-0 padding gives.

``dataset.pipeline: device`` (the JAX Trainer's device pipeline): the host
only decodes to uint8 ``[R, R, 3]`` (``R = transformer.resize_size`` or
``image_size * 8 // 7``), the batch goes to the card from pinned memory,
and the train step augments it there first (``device_prepare_train``:
random-resized crop with the flip, ``transformer.auto_augment`` (default
``ta_wide``), normalisation, ``transformer.random_erase`` (default 0.1));
evaluation center-crops and normalises (``device_prepare_eval``). The draws
come from a ``torch.Generator`` on the device, seeded from
``experiment.seed`` and the step, as JAX folds the step into its key, so a
resumed run draws what the uninterrupted one would have; the streams differ
from JAX's.

Pretrained backbones: ``model.pretrain`` (else ``model.backbone.pretrain``)
names a local file, loaded after the init and before ``model.load`` as
``models/weights.load_pretrained_backbone`` does (``model.pretrain_kind``:
``resnet`` by default, ``vgg`` or ``bbn_inat``); a missing file logs
``training from scratch`` and keeps the init, as in the JAX package.

Not ported yet: multi-process data sharding, ``experiment.profile``.
"""

from __future__ import annotations

import os
import shutil
import sys
import traceback

import numpy as np
import torch

from ..config import setup_config
from ..data import (
    DataLoader,
    FGDataset,
    RandomBatchSampler,
    SequentialBatchSampler,
    SyntheticDataset,
    build_transforms,
)
from ..data.transforms_device import make_eval_transform, make_train_augment
from ..losses import build_criterion
from ..models import build_model, init_parameters
from ..models.weights import load_pretrained_backbone
from ..utils import (
    AverageMeter,
    PerformanceMeter,
    Timer,
    get_logger,
    resolve_device,
    set_random_seed,
)
from . import checkpoint as ckpt
from .optim import build_optimizer, build_scheduler, set_learning_rate


def emergency_save(func):
    """Crash-save wrapper (reference ``train.py:17-34``): on interrupt or any
    exception, log the traceback and write a full checkpoint."""

    def _wrapped(self):
        try:
            return func(self)
        except KeyboardInterrupt:
            self.logger.info("KeyboardInterrupt - saving emergency checkpoint ...")
            self.save_checkpoint()
        except Exception as e:  # noqa: BLE001
            self.logger.error(repr(e))
            self.logger.error(traceback.format_exc())
            self.logger.info("saving emergency checkpoint ...")
            self.save_checkpoint()
            raise

    return _wrapped


def set_tf32(enabled: bool):
    torch.backends.cuda.matmul.allow_tf32 = enabled
    torch.backends.cudnn.allow_tf32 = enabled


class Trainer:
    """Base trainer; Examples subclass and override the ``get_*`` factories
    or ``forward_train``/``forward_eval``/``compute_metrics``."""

    def __init__(self, config=None, device=None):
        self.device = resolve_device(device)
        set_tf32(False)
        self.config = config if config is not None else setup_config()

        self.epoch = 0
        self.start_epoch = 0
        self.step = 0
        self.total_epoch = int(self.config.train.epoch)
        self.resume = (
            self.config.experiment.resume
            if "resume" in self.config.experiment and self.config.experiment.resume
            else None
        )
        self.debug = bool(self.config.experiment.get("debug", False))
        self.log_root = os.path.join(
            self.config.experiment.log_dir, self.config.experiment.name
        )

        # log root must not pre-exist (reference train.py:55) unless resuming
        if not self.resume and not self.debug:
            assert not os.path.exists(self.log_root), (
                f"Experiment log folder already exists: {self.log_root}"
            )
        os.makedirs(self.log_root, exist_ok=True)
        # snapshot config + entry script (reference train.py:59-62)
        with open(os.path.join(self.log_root, "train_config.yaml"), "w") as f:
            f.write(str(self.config))
        try:
            shutil.copyfile(
                sys.argv[0], os.path.join(self.log_root, os.path.basename(sys.argv[0]))
            )
        except (OSError, shutil.SameFileError):
            pass

        self.logger = self.get_logger()
        self.tb_writer = self.get_tb_writer()
        self.logger.info(f"Train Config:\n{self.config}")

        self.seed = int(self.config.experiment.get("seed", 0) or 0)
        self.generator = set_random_seed(self.seed)
        name = (torch.cuda.get_device_name(self.device)
                if self.device.type == "cuda" else "cpu")
        self.logger.info(f"Device: {self.device} ({name})")

        self.pipeline = self.config.dataset.get("pipeline", "host")
        if self.pipeline == "device":
            tcfg = self.config.dataset.transformer
            size = int(tcfg.image_size)
            self.device_augment = make_train_augment(
                image_size=size,
                erase_prob=float(tcfg.get("random_erase", 0.1)),
                auto_augment=tcfg.get("auto_augment", "ta_wide"),
            )
            self.device_eval_prep = make_eval_transform(image_size=size)
            self.aug_generator = torch.Generator(device=self.device)
        elif self.pipeline != "host":
            raise ValueError(f"unknown dataset.pipeline {self.pipeline!r}")
        self.transformers = self.get_transformers(self.config.dataset.transformer)
        self.collate_fn = self.get_collate_fn()
        self.datasets = self.get_dataset(self.config.dataset)
        self.dataloaders = self.get_dataloader(self.config.dataset)

        # model
        self.logger.info(f"Building model {self.config.model.name} ...")
        self.model = self.get_model(self.config.model)
        init_parameters(self.model, self.generator)
        self.load_pretrained()
        if "load" in self.config.model and self.config.model.load:
            self.logger.info(f"Loading model weights from {self.config.model.load}")
            ckpt.load_model(self.config.model.load, self.model, logger=self.logger)
        self.model.to(self.device)
        self.logger.info(f"Building model {self.config.model.name} OK!")

        # criterion / optimizer / scheduler
        self.criterion = self.get_criterion(self.config.train.criterion)
        self.optimizer, base_lr = build_optimizer(
            self.config.train.optimizer, self.get_param_groups())
        self.scheduler = self.get_scheduler(self.config.train.get("scheduler"))

        if self.resume:
            self.logger.info(f"Resuming from `{self.resume}`")
            self.load_checkpoint(self.resume)

        self.performance_meters = self.get_performance_meters()
        self.average_meters = self.get_average_meters()
        self.timer = Timer()
        self.logger.info("Training Preparation Done!")

    def __del__(self):
        if getattr(self, "tb_writer", None) is not None:
            try:
                self.tb_writer.close()
            except Exception:
                pass

    # ------------------------------------------------------------------
    # factories (the reference's override surface, train.py:134-218)
    # ------------------------------------------------------------------
    def get_logger(self):
        return get_logger("hawkeye", log_dir=self.log_root)

    def get_tb_writer(self):
        try:
            from tensorboardX import SummaryWriter

            return SummaryWriter(self.log_root)
        except ImportError:
            return None

    def get_transformers(self, transformer_config):
        if self.pipeline == "device":
            return {"train": None, "val": None}  # the host only decodes
        train_t, eval_t = build_transforms(transformer_config)
        return {"train": train_t, "val": eval_t}

    def get_collate_fn(self):
        from ..data.loader import default_collate

        return {"train": default_collate, "val": default_collate}

    def get_dataset(self, ds_config):
        name = ds_config.get("name", "cub")
        decode = None
        if self.pipeline == "device":
            decode = int(ds_config.transformer.get(
                "resize_size", ds_config.transformer.image_size * 8 // 7))
        if name == "synthetic":
            size = ds_config.transformer.image_size
            n = ds_config.get("length", 256)
            ncls = ds_config.get("num_classes",
                                 self.config.model.get("num_classes", 200))
            return {
                "train": SyntheticDataset(n, ncls, size,
                                          transform=self.transformers["train"],
                                          decode_size=decode),
                "val": SyntheticDataset(max(n // 4, 1), ncls, size,
                                        transform=self.transformers["val"],
                                        decode_size=decode),
            }
        root = ds_config.root_dir
        meta = ds_config.meta_dir
        suffix = ds_config.get("split")
        suffix = f"_{suffix}" if suffix else ""
        return {
            "train": FGDataset(root, os.path.join(meta, f"train{suffix}.txt"),
                               transform=self.transformers["train"],
                               decode_size=decode),
            "val": FGDataset(root, os.path.join(meta, f"val{suffix}.txt"),
                             transform=self.transformers["val"],
                             decode_size=decode),
        }

    def get_sampler(self, split, ds_config):
        n = len(self.datasets[split])
        bs = int(ds_config.batch_size)
        if split == "train":
            return RandomBatchSampler(n, bs, drop_last=True, seed=self.seed)
        return SequentialBatchSampler(n, bs, drop_last=False)

    def get_dataloader(self, ds_config):
        if int(ds_config.get("num_processes", 1)) > 1:
            raise NotImplementedError(
                "multi-process data sharding is not ported yet")
        workers = int(ds_config.get("num_workers", 4))
        return {
            split: DataLoader(self.datasets[split],
                              self.get_sampler(split, ds_config),
                              num_workers=workers,
                              collate_fn=self.collate_fn[split])
            for split in self.datasets
        }

    def get_model(self, model_config):
        return build_model(model_config, self.config.dataset.transformer.image_size)

    def get_criterion(self, criterion_config):
        return build_criterion(criterion_config)

    def load_pretrained(self):
        """The optional pretrained backbone (``hawkeye_tpu/engine/trainer.py``
        reads the same keys)."""
        mcfg = self.config.model
        bb_cfg = mcfg.get("backbone")
        path = bb_cfg.get("pretrain") if hasattr(bb_cfg, "get") else None
        path = mcfg.get("pretrain", path)
        if path:
            load_pretrained_backbone(self.model, path,
                                     mcfg.get("pretrain_kind", "resnet"),
                                     logger=self.logger)

    def get_param_groups(self):
        """Override to return group dicts ``{"params": [...], "lr_mult": m}``."""
        return self.model.parameters()

    def get_scheduler(self, scheduler_config):
        return build_scheduler(scheduler_config,
                               float(self.config.train.optimizer.lr))

    def get_performance_meters(self):
        return {
            "train": {m: PerformanceMeter() for m in ("acc", "loss")},
            "val": {m: PerformanceMeter() for m in ("acc", "loss")},
        }

    def get_average_meters(self):
        return {m: AverageMeter(m) for m in ("acc", "loss")}

    # ------------------------------------------------------------------
    # step functions (override points)
    # ------------------------------------------------------------------
    def apply_model(self, batch, train):
        """One forward pass; subclasses change the call signature here."""
        return self.model(batch["img"])

    def forward_train(self, batch):
        """Returns (loss, outputs)."""
        outputs = self.apply_model(batch, True)
        return self.criterion(outputs, batch), outputs

    def forward_eval(self, batch):
        outputs = self.apply_model(batch, False)
        return self.criterion(outputs, batch), outputs

    def compute_metrics(self, outputs, batch):
        """Device scalars; a 'weight' in the batch masks samples out."""
        labels = batch["label"]
        if labels.dim() == 2:
            labels = labels.argmax(-1)
        pred = outputs["logits"].argmax(-1)
        w = batch.get("weight")
        if w is None:
            w = torch.ones_like(labels, dtype=torch.float32)
        correct = (pred == labels).float() * w
        return {"correct": correct.sum(), "count": w.sum()}

    def transform_grads(self, batch):
        """Gradient hook between backward and the update (grads in ``.grad``)."""

    def device_prepare_train(self, generator, batch):
        """Device-pipeline train-batch prep (override point): the standard
        augmentation of ``img``. Methods with their own batch law override
        this to rebuild the whole batch on the device."""
        batch = dict(batch)
        batch["img"] = self.device_augment(generator, batch["img"])
        return batch

    def device_prepare_eval(self, batch):
        """Device-pipeline eval-batch prep (override point)."""
        batch = dict(batch)
        batch["img"] = self.device_eval_prep(batch["img"])
        return batch

    def prepare_batch(self, batch, train):
        """Host numpy batch -> dict of tensors on the device (from pinned
        memory on CUDA, so the copy does not hold up the host)."""
        out = {}
        for k, v in batch.items():
            if isinstance(v, np.ndarray) and v.dtype.kind in "fiub":
                t = torch.from_numpy(np.ascontiguousarray(v))
                if self.device.type == "cuda":
                    t = t.pin_memory()
                out[k] = t.to(self.device, non_blocking=True)
            else:
                out[k] = v
        return out

    def train_step_call(self, batch, lr):
        """One optimizer step on a prepared batch; returns device metrics."""
        if self.pipeline == "device":
            # one stream of draws per step, as JAX folds the step into its key
            self.aug_generator.manual_seed(self.seed * 2**32 + self.step)
            batch = self.device_prepare_train(self.aug_generator, batch)
        self.model.train()
        set_learning_rate(self.optimizer, lr)
        self.optimizer.zero_grad(set_to_none=False)
        loss, outputs = self.forward_train(batch)
        loss.backward()
        self.transform_grads(batch)
        for group in self.optimizer.param_groups:
            for p in group["params"]:
                if p.grad is None:  # frozen this step: decay + momentum still apply
                    p.grad = torch.zeros_like(p)
        self.optimizer.step()
        self.step += 1
        with torch.no_grad():
            return {"loss": loss.detach(), **self.compute_metrics(outputs, batch)}

    @torch.no_grad()
    def eval_step_call(self, batch):
        if self.pipeline == "device":
            batch = self.device_prepare_eval(batch)
        self.model.eval()
        loss, outputs = self.forward_eval(batch)
        return {"loss": loss, **self.compute_metrics(outputs, batch)}

    # ------------------------------------------------------------------
    # the training loop (reference train.py:240-308)
    # ------------------------------------------------------------------
    @emergency_save
    def train(self):
        self.on_start_train()
        if bool(self.config.train.get("val_first", False)):
            self.logger.info("validate before training (val_first)")
            self.validate()

        saved_this_epoch = False
        for epoch in range(self.start_epoch, self.total_epoch):
            self.epoch = epoch
            self.on_start_epoch()
            self.timer.tick()

            lr = self.scheduler.epoch_lr(epoch)
            train_metrics = self.train_epoch(lr)
            train_time = self.timer.tick()

            self.performance_meters["train"]["acc"].update(train_metrics["acc"])
            self.performance_meters["train"]["loss"].update(train_metrics["loss"])

            val_metrics = self.validate()
            val_time = self.timer.tick()

            images_per_sec = train_metrics["count"] / max(train_time, 1e-9)
            self.logger.info(
                f"Epoch {epoch}: lr {lr:.2e} | "
                f"train acc {train_metrics['acc']:.2f} loss {train_metrics['loss']:.4f} "
                f"({train_time:.1f}s, {images_per_sec:.1f} img/s) | "
                f"val acc {val_metrics['acc']:.2f} loss {val_metrics['loss']:.4f} "
                f"({val_time:.1f}s)"
            )
            self.report(epoch, lr, train_metrics, val_metrics, images_per_sec)

            # best tracking: reference records best only from epoch >= 5
            # (train.py:284-289); for very short runs the gate is dropped
            gate = 5 if self.total_epoch > 5 else 0
            is_best = False
            if epoch >= gate:
                best = self.performance_meters["val"]["acc"].best_value
                if best is None or val_metrics["acc"] >= best:
                    is_best = True
            self.performance_meters["val"]["acc"].update(val_metrics["acc"])
            self.performance_meters["val"]["loss"].update(val_metrics["loss"])
            if is_best:
                self.save_model(os.path.join(self.log_root, "best_model.pt"))
                self.logger.info(
                    f"best model saved (val acc {val_metrics['acc']:.2f})"
                )

            self.scheduler.step_metric(val_metrics["acc"])

            save_freq = int(self.config.train.get("save_frequence", 0) or 0)
            saved_this_epoch = False
            if save_freq and (epoch + 1) % save_freq == 0:
                self.save_model(
                    os.path.join(self.log_root, f"model_epoch_{epoch}.pt"))
                self.save_checkpoint()
                saved_this_epoch = True

            self.on_end_epoch()

        if not saved_this_epoch:
            self.save_checkpoint()
        self.on_end_train()
        best = self.performance_meters["val"]["acc"].best_value
        if best is not None:
            self.logger.info(
                f"Training done. best val acc {best:.2f} @ epoch "
                f"{self.performance_meters['val']['acc'].best_epoch}"
            )

    def train_epoch(self, lr):
        for m in self.average_meters.values():
            m.reset()
        loader = self.dataloaders["train"]
        loader.set_epoch(self.epoch)
        totals = None  # device sums, read once at the end of the epoch
        n = 0
        try:
            from tqdm import tqdm

            iterator = tqdm(loader, total=len(loader), leave=False,
                            desc=f"epoch {self.epoch}", mininterval=1.0)
        except ImportError:
            iterator = loader
        for batch in iterator:
            self.on_start_batch(batch)
            metrics = self.train_step_call(self.prepare_batch(batch, train=True),
                                           self.batch_lr(lr))
            totals = (dict(metrics) if totals is None else
                      {k: totals[k] + metrics[k] for k in totals})
            n += 1
            self.on_end_batch(metrics)
        if totals is None:
            return {"acc": 0.0, "loss": 0.0, "count": 0.0}
        totals = {k: float(v) for k, v in totals.items()}
        return {
            "acc": 100.0 * totals["correct"] / max(totals["count"], 1.0),
            "loss": totals["loss"] / max(n, 1),
            "count": totals["count"],
        }

    def batch_lr(self, epoch_lr):
        """Per-step LR hook (per-batch cosine recipes override this)."""
        return epoch_lr

    def validate(self):
        loader = self.dataloaders.get("val")
        if loader is None:
            return {"acc": 0.0, "loss": 0.0}
        totals = None
        n = 0
        for batch in loader:
            metrics = self.eval_step_call(self.prepare_batch(batch, train=False))
            totals = (dict(metrics) if totals is None else
                      {k: totals[k] + metrics[k] for k in totals})
            n += 1
        if totals is None:
            return {"acc": 0.0, "loss": 0.0}
        totals = {k: float(v) for k, v in totals.items()}
        return {
            "acc": 100.0 * totals["correct"] / max(totals["count"], 1.0),
            "loss": totals["loss"] / max(n, 1),
        }

    def report(self, epoch, lr, train_metrics, val_metrics, images_per_sec):
        if self.tb_writer is None:
            return
        self.tb_writer.add_scalar("train/acc", train_metrics["acc"], epoch)
        self.tb_writer.add_scalar("train/loss", train_metrics["loss"], epoch)
        self.tb_writer.add_scalar("val/acc", val_metrics["acc"], epoch)
        self.tb_writer.add_scalar("val/loss", val_metrics["loss"], epoch)
        self.tb_writer.add_scalar("lr", lr, epoch)
        self.tb_writer.add_scalar("perf/images_per_sec", images_per_sec, epoch)

    # ------------------------------------------------------------------
    # checkpointing (reference train.py:369-395)
    # ------------------------------------------------------------------
    def save_model(self, path):
        ckpt.save_model(path, self.model)

    def save_checkpoint(self, path=None):
        path = path or os.path.join(self.log_root,
                                    f"checkpoint_epoch_{self.epoch}.pt")
        ckpt.save_checkpoint(
            path, epoch=self.epoch, model=self.model, optimizer=self.optimizer,
            scheduler_state=self.scheduler.state_dict(),
            extra={"step": int(self.step)})
        self.logger.info(f"checkpoint saved: {path}")

    def load_checkpoint(self, path):
        epoch, sched_state, extra = ckpt.load_checkpoint(
            path, model=self.model, optimizer=self.optimizer, device=self.device)
        self.scheduler.load_state_dict(sched_state)
        self.step = int(extra.get("step", 0))
        self.start_epoch = epoch + 1
        self.logger.info(f"resumed at epoch {self.start_epoch}")

    # ------------------------------------------------------------------
    # hooks (reference train.py:397-434)
    # ------------------------------------------------------------------
    def on_start_train(self):
        pass

    def on_end_train(self):
        pass

    def on_start_epoch(self):
        pass

    def on_end_epoch(self):
        pass

    def on_start_batch(self, batch):
        pass

    def on_end_batch(self, metrics):
        pass
