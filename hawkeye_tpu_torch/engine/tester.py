"""Eval-only runtime.

Counterpart of ``hawkeye_tpu/engine/tester.py`` (reference ``test.py:14-147``):
``model.load`` is required, the val split only, top-1 accuracy over the real
samples, one log line, and ``test()`` returns the accuracy. The pipeline
follows the Trainer's: ``dataset.pipeline: host`` runs the PIL
``EvalPreset`` on the host; ``device`` decodes uint8 ``[R, R, 3]`` on the
host and center-crops and normalises on the device. The model runs on CUDA
unless the caller passes ``device="cpu"``; on one device no batch is padded.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..config import setup_config
from ..data import DataLoader, FGDataset, SequentialBatchSampler, SyntheticDataset
from ..data.transforms_device import make_eval_transform
from ..data.transforms_host import EvalPreset
from ..models import build_model, init_parameters
from ..utils import Timer, get_logger, resolve_device
from . import checkpoint as ckpt
from .trainer import set_tf32


class Tester:
    __test__ = False  # keep pytest from collecting this as a test class

    def __init__(self, config=None, device=None):
        self.device = resolve_device(device)
        set_tf32(False)
        self.config = config if config is not None else setup_config()
        if not self.config.model.get("load"):
            raise ValueError("the Tester needs config.model.load "
                             "(reference test.py:71-75)")
        self.logger = get_logger("hawkeye.test")

        tcfg = self.config.dataset.transformer
        image_size = int(tcfg.image_size)
        resize_size = int(tcfg.get("resize_size", image_size * 8 // 7))
        self.pipeline = self.config.dataset.get("pipeline", "host")
        if self.pipeline not in ("host", "device"):
            raise ValueError(f"unknown dataset.pipeline {self.pipeline!r}")
        self._decode_size = resize_size if self.pipeline == "device" else None
        if self.pipeline == "device":
            self.device_eval_prep = make_eval_transform(image_size=image_size)
        self.transformer = self.get_transformer(image_size, resize_size)

        self.dataset = self.get_dataset(self.config.dataset)
        bs = int(self.config.dataset.batch_size)
        self.dataloader = DataLoader(
            self.dataset,
            SequentialBatchSampler(len(self.dataset), bs, drop_last=False),
            num_workers=int(self.config.dataset.get("num_workers", 4)),
        )

        self.model = self.get_model(self.config.model)
        init_parameters(self.model, torch.Generator().manual_seed(0))
        ckpt.load_model(self.config.model.load, self.model, logger=self.logger)
        self.model.to(self.device).eval()
        self.timer = Timer()

    def get_transformer(self, image_size, resize_size):
        if self.pipeline == "device":
            return None  # the host only decodes
        return EvalPreset(image_size, resize_size)

    def get_dataset(self, ds_config):
        if ds_config.get("name") == "synthetic":
            return SyntheticDataset(
                ds_config.get("length", 64),
                ds_config.get("num_classes", self.config.model.num_classes),
                ds_config.transformer.image_size,
                transform=self.transformer,
                decode_size=self._decode_size,
            )
        return FGDataset(
            ds_config.root_dir,
            os.path.join(ds_config.meta_dir, "val.txt"),
            transform=self.transformer,
            decode_size=self._decode_size,
        )

    def get_model(self, model_config):
        return build_model(model_config, self.config.dataset.transformer.image_size)

    def prepare_batch(self, batch):
        """Host numpy batch -> image and label tensors on the device."""
        out = {}
        for k in ("img", "label"):
            t = torch.from_numpy(np.ascontiguousarray(batch[k]))
            if self.device.type == "cuda":
                t = t.pin_memory()
            out[k] = t.to(self.device, non_blocking=True)
        if self.pipeline == "device":
            out["img"] = self.device_eval_prep(out["img"])
        return out

    @torch.no_grad()
    def eval_step(self, batch):
        outputs = self.model(batch["img"])
        logits = outputs["logits"] if isinstance(outputs, dict) else outputs
        return (logits.argmax(-1) == batch["label"]).sum()

    def test(self):
        self.timer.tick()
        correct = None
        count = 0
        for batch in self.dataloader:
            c = self.eval_step(self.prepare_batch(batch))
            correct = c if correct is None else correct + c
            count += len(batch["label"])
        correct = 0 if correct is None else int(correct)  # one device read
        elapsed = self.timer.tick()
        acc = 100.0 * correct / max(count, 1)
        self.logger.info(
            f"Test top-1 accuracy: {acc:.2f}% ({count} images, "
            f"{elapsed:.1f}s, {count / max(elapsed, 1e-9):.1f} img/s)"
        )
        return acc
