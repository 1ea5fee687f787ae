"""MGE-CNN (reference ``Examples/MGE_CNN.py``, ``configs/MGE_CNN.yaml``):
the labels pick the CAM's class in a train forward; the four backbones
(``expert_{i}.backbone``, ``gate_backbone``) at ``train.optimizer.lr_rate``
(default 0.1) times the LR, every head at 1x; the recipe's Adam with its
warm-up cosine. ``train.steps_per_dispatch`` is read and ignored, as the
Trainer documents."""

from ..engine import Trainer
from ..engine.optim import prefix_param_groups
from ..train import main


class MGETrainer(Trainer):
    def get_param_groups(self):
        lr_rate = float(self.config.train.optimizer.get("lr_rate", 0.1))
        rules = {f"expert_{i}.backbone": "extractor" for i in range(3)}
        rules["gate_backbone"] = "extractor"
        return prefix_param_groups(self.model, rules,
                                   {"extractor": lr_rate, "classifier": 1.0},
                                   default="classifier")

    def apply_model(self, batch, train):
        if train:
            return self.model(batch["img"], labels=batch["label"])
        return self.model(batch["img"])


if __name__ == "__main__":
    main(trainer_cls=MGETrainer)
