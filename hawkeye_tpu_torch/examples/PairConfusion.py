"""Pairwise Confusion (reference ``Examples/PairConfusion.py:10-38``):
Baseline ResNet-50 with the euclidean-confusion criterion
(``configs/PC_resnet50.yaml``); no model changes."""

from ..engine import Trainer
from ..train import main


class PairConfusionTrainer(Trainer):
    pass


if __name__ == "__main__":
    main(trainer_cls=PairConfusionTrainer)
