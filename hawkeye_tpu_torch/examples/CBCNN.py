"""CBCNN two-stage training (``configs/CBCNN_S1.yaml`` then ``_S2.yaml``):
the base Trainer; stage 2 loads stage 1's best model through
``model.load``, whose ``.msgpack`` name reads the port's ``.pt`` file."""

from ..engine import Trainer
from ..train import main


class CBCNNTrainer(Trainer):
    pass


if __name__ == "__main__":
    main(trainer_cls=CBCNNTrainer)
