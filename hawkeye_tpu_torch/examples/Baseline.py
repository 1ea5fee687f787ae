"""Baseline ResNet-50 training (reference ``Examples/Baseline.py``)."""

from ..engine import Trainer
from ..train import main


class BaselineTrainer(Trainer):
    pass


if __name__ == "__main__":
    main(trainer_cls=BaselineTrainer)
