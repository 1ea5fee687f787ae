"""Interp-Parts (reference ``Examples/InterpPartsNet.py``,
``configs/InterpPartsNet.yaml``): the backbone at 1x the LR and every other
parameter (the grouping unit, the attention and post blocks, the
classifier) at 20x; a cosine over every train batch of the run
(``len(train loader) * epochs`` steps) through ``batch_lr``, in place of
the epoch scheduler. A resumed run continues the cosine from
``start_epoch * len(train loader)``."""

import math

from ..engine import Trainer
from ..engine.optim import LRScheduler, prefix_param_groups
from ..train import main


class InterpPartsTrainer(Trainer):
    def __init__(self, config=None, device=None):
        self._global_step = 0
        super().__init__(config, device)
        steps = len(self.dataloaders["train"])
        self._total_steps = max(steps * self.total_epoch, 1)
        # load_checkpoint in Trainer.__init__ sets start_epoch
        self._global_step = self.start_epoch * steps

    def get_param_groups(self):
        return prefix_param_groups(self.model, {"backbone": "finetune"},
                                   {"finetune": 1.0, "scratch": 20.0},
                                   default="scratch")

    def get_scheduler(self, scheduler_config):
        return LRScheduler(float(self.config.train.optimizer.lr))

    def batch_lr(self, epoch_lr):
        base = float(self.config.train.optimizer.lr)
        t = min(self._global_step / self._total_steps, 1.0)
        self._global_step += 1
        return 0.5 * base * (1.0 + math.cos(math.pi * t))


if __name__ == "__main__":
    main(trainer_cls=InterpPartsTrainer)
