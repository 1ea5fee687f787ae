"""Fast MPN-COV training (``configs/MPN.yaml``).

Parameter groups: the backbone at 0.2x the base LR, the reduction conv, its
BatchNorm and the classifier at 1x (reference ``Examples/MPN.py:13-18``);
the warm-up cosine schedule comes from the scheduler config's warm-up
fields (``engine/optim.py``'s ``CosineAnnealingLR``)."""

from ..engine import Trainer
from ..engine.optim import prefix_param_groups
from ..train import main


class MPNTrainer(Trainer):
    def get_param_groups(self):
        return prefix_param_groups(self.model, {"backbone": "backbone"},
                                   {"backbone": 0.2, "head": 1.0})


if __name__ == "__main__":
    main(trainer_cls=MPNTrainer)
