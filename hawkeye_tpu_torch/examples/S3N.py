"""S3N (reference ``Examples/S3N.py``, ``configs/S3N.yaml``): the phase by
epoch (train 0 before epoch 20, else 1; validation 1 before epoch 20, else
2) and three LR groups: the four classifiers at 1x, ``radius``,
``radius_inv`` and ``blur_kernel`` at 1e-5x, everything else at 0.1x. A
train forward at phase 1 draws from the Trainer's ``model_generator``; a
validation forward from a generator seeded 0 for every batch, as the JAX
trainer passes ``PRNGKey(0)`` there. The Tester calls the model at its
default phase 0, as the JAX Tester does."""

import torch

from ..engine import Trainer
from ..engine.optim import prefix_param_groups
from ..train import main


class S3NTrainer(Trainer):
    def get_param_groups(self):
        rules = {"raw_classifier": "cls", "sampler_classifier": "cls",
                 "sampler_classifier1": "cls", "con_classifier": "cls",
                 "radius": "slow", "radius_inv": "slow", "blur_kernel": "slow"}
        return prefix_param_groups(self.model, rules,
                                   {"cls": 1.0, "slow": 1e-5, "base": 0.1},
                                   default="base")

    def train_phase(self):
        return 0 if self.epoch < 20 else 1

    def eval_phase(self):
        return 1 if self.epoch < 20 else 2

    def eval_generator(self):
        """The validation forward's generator, seeded 0 anew for each batch."""
        if getattr(self, "_eval_generator", None) is None:
            self._eval_generator = torch.Generator(device=self.device)
        return self._eval_generator.manual_seed(0)

    def apply_model(self, batch, train):
        if train:
            return self.model(batch["img"], p=self.train_phase(),
                              generator=self.model_generator())
        return self.model(batch["img"], p=self.eval_phase(),
                          generator=self.eval_generator())


if __name__ == "__main__":
    main(trainer_cls=S3NTrainer)
