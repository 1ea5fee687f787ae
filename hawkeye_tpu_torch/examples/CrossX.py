"""CrossX (reference ``Examples/CrossX.py``, ``configs/CrossX.yaml``): the
plain Trainer; the recipe's MultiStepLR comes from ``engine/optim.py``."""

from ..engine import Trainer
from ..train import main


class CrossXTrainer(Trainer):
    pass


if __name__ == "__main__":
    main(trainer_cls=CrossXTrainer)
