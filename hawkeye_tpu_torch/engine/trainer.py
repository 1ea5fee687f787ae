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
and ignored: batch padding to a device multiple,
``train.steps_per_dispatch``, ``train.remat``, ``train.async_checkpoint``.
Validation needs no padding: each batch's loss is its mean over its real
samples and the epoch's loss the mean over batches, as the JAX trainer's
weight-0 padding gives.

Data parallelism over processes (``torchrun --nproc_per_node=N -m
hawkeye_tpu_torch.train ...``; ``parallel/``), the counterpart of the JAX
Trainer's sharded global batch: the process group comes from ``torchrun``'s
environment (or is the caller's), each process runs on ``cuda:LOCAL_RANK``
(or the device the caller names) and loads its slice of every global batch
of ``dataset.batch_size`` rows (``dataset.num_processes`` and
``dataset.process_index`` default to the world size and rank, as the JAX
Trainer reads them; the val tail is padded with weight-0 rows). The ranks
start from rank 0's weights, BatchNorm takes its statistics over the global
batch (``norm.set_cross_replica``), and the gradients are averaged over the
ranks after the backward: train batches are full (``drop_last``), so that
mean of per-rank mean losses is the JAX step's global mean. Train metrics
and validation's sums are all-reduced, so a padded val row counts nowhere
and each val batch's loss is its mean over the global batch's real rows.
Rank 0 alone writes the log, TensorBoard, the config snapshot and
checkpoints.

``experiment.profile``: ``torch.profiler`` traces steps 3-8 of epoch 0
(CPU and, on the card, CUDA activity) into ``<log_root>/profile`` as a
Chrome trace, and the log says so, as the JAX Trainer's
``jax.profiler`` trace does. While a profiler records, the port's own spans
(``utils/trace.py``) are ranges named ``hk::<span>`` in that trace:
``data.wait`` and ``data.collate`` (the loader's main thread), ``pin``
(``prepare_batch``), ``augment``, ``forward`` and ``backward`` (the train
step), ``batch_norm`` (each train-mode normalisation; the summary reads
its backward, ``batch_norm.backward``, from the profiler's records of the
autograd nodes), ``allreduce.bn_stats`` and ``allreduce.grads`` (across
processes). The Trainer resets the tracer when its profiler starts and,
after writing the trace, logs one line of the tracer's summary: each
span's calls, host ms and device ms a traced step (device ms: the device
time of the work launched while the span was open, read from the
profiler's events), and the counters a step (``collective.calls``,
``collective.bytes``).

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
"""

from __future__ import annotations

import logging
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
from ..data import native_decoder
from ..data.transforms_device import make_eval_transform, make_train_augment
from ..losses import build_criterion
from ..models import build_model, init_parameters
from ..models.backbones.norm import set_cross_replica
from ..models.weights import load_pretrained_backbone
from ..parallel import (
    PaddingAwareDataset,
    ProcessShardedBatchSampler,
    all_reduce_sum,
    average_gradients,
    broadcast_module,
    init_from_env,
    local_rank,
)
from ..utils import (
    AverageMeter,
    PerformanceMeter,
    Timer,
    get_logger,
    resolve_device,
    set_random_seed,
    trace,
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
        self.rank, self.world_size = init_from_env(self.device.type)
        if self.device.type == "cuda" and device is None and self.world_size > 1:
            self.device = torch.device("cuda", local_rank())
        if self.device.index is not None and self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        self.is_main = self.rank == 0

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

        if self.is_main:  # rank 0 alone writes
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
        self._model_generator = None  # made on first use (model_generator)
        name = (torch.cuda.get_device_name(self.device)
                if self.device.type == "cuda" else "cpu")
        self.logger.info(f"Device: {self.device} ({name})"
                         + (f", rank {self.rank} of {self.world_size} processes"
                            if self.world_size > 1 else ""))

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
        if any(isinstance(d, FGDataset) and d.decode_size is not None
               for d in self.datasets.values()):
            self.logger.info(f"JPEG decode: {native_decoder.describe()}")
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
        if self.world_size > 1:
            set_cross_replica(self.model, True)  # the global batch's statistics
            broadcast_module(self.model)
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
        if not self.is_main:
            quiet = logging.getLogger(f"hawkeye.rank{self.rank}")
            quiet.handlers = [logging.NullHandler()]
            quiet.propagate = False
            return quiet
        return get_logger("hawkeye", log_dir=self.log_root)

    def get_tb_writer(self):
        if not self.is_main:
            return None
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
        workers = int(ds_config.get("num_workers", 4))
        # each process loads only its slice of every global batch; the keys
        # make the slicing testable in one process, as in the JAX Trainer
        n_proc = int(ds_config.get("num_processes", self.world_size))
        proc_idx = int(ds_config.get("process_index", self.rank))
        loaders = {}
        for split in self.datasets:
            dataset = self.datasets[split]
            sampler = self.get_sampler(split, ds_config)
            if n_proc > 1:
                sampler = ProcessShardedBatchSampler(
                    sampler, process_index=proc_idx, process_count=n_proc)
                dataset = PaddingAwareDataset(dataset)
            loaders[split] = DataLoader(dataset, sampler, num_workers=workers,
                                        collate_fn=self.collate_fn[split])
        return loaders

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
        with trace.span("augment"):
            batch["img"] = self.device_augment(generator, batch["img"])
        return batch

    def device_prepare_eval(self, batch):
        """Device-pipeline eval-batch prep (override point)."""
        batch = dict(batch)
        batch["img"] = self.device_eval_prep(batch["img"])
        return batch

    def model_generator(self):
        """A generator on the device for the model's own train-mode draws
        (dropout masks, a dropblock), seeded from ``experiment.seed`` and
        the step, as the JAX step folds the step into its key, so a resumed
        run draws what the uninterrupted one would have; bit 63 keeps the
        stream apart from the augmentation's seeds."""
        if self._model_generator is None:
            self._model_generator = torch.Generator(device=self.device)
        self._model_generator.manual_seed((self.seed * 2**32 + self.step) | 1 << 63)
        return self._model_generator

    def prepare_batch(self, batch, train):
        """Host numpy batch -> dict of tensors on the device (from pinned
        memory on CUDA, so the copy does not hold up the host); the span
        ``pin``."""
        out = {}
        with trace.span("pin"):
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
        """One optimizer step on a prepared batch; returns device metrics.
        One traced step of ``utils/trace.py``, with the spans ``forward`` and
        ``backward``."""
        trace.step()
        if self.pipeline == "device":
            # one stream of draws per step, as JAX folds the step into its key
            self.aug_generator.manual_seed(self.seed * 2**32 + self.step)
            batch = self.device_prepare_train(self.aug_generator, batch)
        self.model.train()
        set_learning_rate(self.optimizer, lr)
        self.optimizer.zero_grad(set_to_none=False)
        with trace.span("forward"):
            loss, outputs = self.forward_train(batch)
        with trace.span("backward"):
            loss.backward()
        average_gradients(self.model.parameters())  # no-op in one process
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
        profiler = None
        profile = (bool(self.config.experiment.get("profile", False))
                   and self.epoch == 0 and self.is_main)
        iterator = loader
        if self.is_main:  # one progress bar, rank 0's
            try:
                from tqdm import tqdm

                iterator = tqdm(loader, total=len(loader), leave=False,
                                desc=f"epoch {self.epoch}", mininterval=1.0)
            except ImportError:
                pass
        for batch in iterator:
            if profile and n == 3:  # steps 3-8 of epoch 0, as the JAX Trainer
                profiler = self._start_profile()
            if profiler is not None and n == 8:
                self._stop_profile(profiler)
                profiler = profile = None
            self.on_start_batch(batch)
            metrics = self.train_step_call(self.prepare_batch(batch, train=True),
                                           self.batch_lr(lr))
            totals = (dict(metrics) if totals is None else
                      {k: totals[k] + metrics[k] for k in totals})
            n += 1
            self.on_end_batch(metrics)
        if profiler is not None:  # an epoch of fewer than 9 steps
            self._stop_profile(profiler)
        if totals is None:
            return {"acc": 0.0, "loss": 0.0, "count": 0.0}
        sums = all_reduce_sum(torch.stack(
            [totals[k].double() for k in ("correct", "count", "loss")])).tolist()
        correct, count, loss = sums
        return {
            "acc": 100.0 * correct / max(count, 1.0),
            # the mean over steps of the mean over ranks of each rank's loss
            "loss": loss / max(n, 1) / self.world_size,
            "count": count,
        }

    def _start_profile(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.start()
        trace.reset()
        return profiler

    def _stop_profile(self, profiler):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        profiler.stop()
        profile_dir = os.path.join(self.log_root, "profile")
        os.makedirs(profile_dir, exist_ok=True)
        profiler.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
        self.logger.info(f"profiler trace written to {profile_dir}")
        self.logger.info(trace.describe(trace.summary(profiler.events())))

    def batch_lr(self, epoch_lr):
        """Per-step LR hook (per-batch cosine recipes override this)."""
        return epoch_lr

    def validate(self):
        loader = self.dataloaders.get("val")
        if loader is None:
            return {"acc": 0.0, "loss": 0.0}
        rows = []  # per batch: loss, correct, count (device scalars)
        for batch in loader:
            m = self.eval_step_call(self.prepare_batch(batch, train=False))
            rows.append(torch.stack([m["loss"].double(), m["correct"].double(),
                                     m["count"].double()]))
        if not rows:
            return {"acc": 0.0, "loss": 0.0}
        rows = torch.stack(rows)
        if self.world_size > 1:
            # each batch's loss over the global batch's real rows: the ranks'
            # means weighted by their counts (a weight-0 pad counts nowhere)
            rows[:, 0] *= rows[:, 2]
            all_reduce_sum(rows)
            rows[:, 0] /= rows[:, 2].clamp_min(1.0)
        loss_sum, correct, count = rows.sum(0).tolist()
        return {
            "acc": 100.0 * correct / max(count, 1.0),
            "loss": loss_sum / len(rows),
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
        if self.is_main:
            ckpt.save_model(path, self.model)

    def save_checkpoint(self, path=None):
        if not self.is_main:
            return
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
