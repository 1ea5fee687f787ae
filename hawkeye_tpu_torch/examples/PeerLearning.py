"""Peer-Learning on webly-supervised data (reference
``Examples/PeerLearning.py``; ``configs/PeerLearning_BCNN_S1.yaml`` then
``_S2.yaml``).

* the drop rate ramps linearly from 0 over the first ``T_k`` epochs, in
  float32 (``np.full`` then ``np.linspace``), and goes into each train batch
  as ``drop_rate`` (``prepare_batch``);
* the two peer losses are summed: the peers' parameters are disjoint, so one
  backward equals the reference's two;
* ``acc1``/``acc2`` meters: ``compute_metrics`` adds each peer's
  ``correct1``/``correct2``; the per-batch device scalars are summed on the
  device and read once per epoch, for the peer log line.
"""

import numpy as np
import torch

from ..engine import Trainer
from ..train import main
from ..utils import PerformanceMeter


class PLTrainer(Trainer):
    def __init__(self, config=None, device=None):
        super().__init__(config, device)
        drop_rate = float(self.config.model.get("drop_rate", 0.25))
        t_k = int(self.config.model.get("T_k", 10))
        self.rate_schedule = np.full(self.total_epoch, drop_rate, np.float32)
        self.rate_schedule[:t_k] = np.linspace(0.0, drop_rate,
                                               min(t_k, self.total_epoch))
        self._peer_sums = None

    def get_performance_meters(self):
        meters = super().get_performance_meters()
        for m in ("acc1", "acc2"):
            meters["train"][m] = PerformanceMeter()
            meters["val"][m] = PerformanceMeter()
        return meters

    def prepare_batch(self, batch, train):
        device_batch = super().prepare_batch(batch, train)
        if train:
            device_batch["drop_rate"] = float(self.rate_schedule[self.epoch])
        return device_batch

    def compute_metrics(self, outputs, batch):
        metrics = super().compute_metrics(outputs, batch)
        if "logits1" in outputs:
            w = batch.get("weight")
            if w is None:
                w = torch.ones_like(batch["label"], dtype=torch.float32)
            for i in (1, 2):
                pred = outputs[f"logits{i}"].argmax(-1)
                metrics[f"correct{i}"] = ((pred == batch["label"]).float() * w).sum()
        return metrics

    def train_epoch(self, lr):
        self._peer_sums = None
        out = super().train_epoch(lr)
        if self._peer_sums is not None:
            c1, c2, n = (float(v) for v in self._peer_sums)  # one read per epoch
            n = max(n, 1.0)
            acc1, acc2 = 100.0 * c1 / n, 100.0 * c2 / n
            self.performance_meters["train"]["acc1"].update(acc1)
            self.performance_meters["train"]["acc2"].update(acc2)
            self.logger.info(
                f"Epoch {self.epoch}: peer acc1 {acc1:.2f} acc2 {acc2:.2f} "
                f"(drop rate {self.rate_schedule[self.epoch]:.3f})")
        return out

    def on_end_batch(self, metrics):
        if "correct1" in metrics:
            step = (metrics["correct1"], metrics["correct2"], metrics["count"])
            self._peer_sums = (step if self._peer_sums is None else
                               tuple(a + b for a, b in zip(self._peer_sums, step)))


if __name__ == "__main__":
    main(trainer_cls=PLTrainer)
