"""AP-CNN (reference ``Examples/APCNN.py``, ``configs/APCNN.yaml``): the
summed 8-head CE, the recipe's SGD with its per-epoch cosine, and the trunk
(``conv1``, ``bn1``, ``layer{1..4}_{j}``) at 0.1x the LR of the heads
(every other parameter). The train forward takes the Trainer's
``model_generator`` for the ROI dropblock's draws."""

from ..engine import Trainer
from ..engine.optim import prefix_param_groups
from ..train import main


class APCNNTrainer(Trainer):
    def get_param_groups(self):
        # reference: children[:7] (the ResNet trunk) at lr/10, heads at lr
        rules = {"conv1": "trunk", "bn1": "trunk"}
        rules.update({name: "trunk" for names in self.model.stage_names
                      for name in names})
        return prefix_param_groups(self.model, rules, {"trunk": 0.1, "head": 1.0},
                                   default="head")

    def apply_model(self, batch, train):
        if not train:
            return self.model(batch["img"])
        return self.model(batch["img"], generator=self.model_generator())


if __name__ == "__main__":
    main(trainer_cls=APCNNTrainer)
