"""BCNN two-stage training (reference ``Examples/BCNN.py``): the base
Trainer covers the recipe; stage 2 loads stage 1's best model through
``model.load``."""

from ..engine import Trainer
from ..train import main


class BCNNTrainer(Trainer):
    pass


if __name__ == "__main__":
    main(trainer_cls=BCNNTrainer)
