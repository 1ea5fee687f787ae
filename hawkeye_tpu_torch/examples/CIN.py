"""CIN (reference ``Examples/CIN.py``, ``configs/CIN.yaml``): P x K
balanced train batches (4 x 5); the contrastive projection (the reference
criterion's ``h``) trains inside the model as ``pair_head``
(``losses/cin.py``)."""

from ..train import main
from .OSMENet import BalancedSamplerTrainer


class CINTrainer(BalancedSamplerTrainer):
    pass


if __name__ == "__main__":
    main(trainer_cls=CINTrainer)
