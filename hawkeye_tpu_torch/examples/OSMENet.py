"""OSME + MAMC (reference ``Examples/OSMENet.py:18-33``,
``configs/OSMENet.yaml``): P x K balanced train batches
(``dataset.n_classes`` classes x ``dataset.n_samples`` images) so that the
n-pairs loss has positives in every batch. ``BalancedSamplerTrainer`` is
the base of the API-Net and CIN trainers too."""

from ..data import BalancedBatchSampler
from ..engine import Trainer
from ..train import main


class BalancedSamplerTrainer(Trainer):
    """A Trainer whose train batches are P x K balanced."""

    def get_sampler(self, split, ds_config):
        if split == "train":
            return BalancedBatchSampler(
                self.datasets["train"].labels,
                n_classes=int(ds_config.n_classes),
                n_samples=int(ds_config.n_samples),
                seed=self.seed)
        return super().get_sampler(split, ds_config)


class OSMETrainer(BalancedSamplerTrainer):
    pass


if __name__ == "__main__":
    main(trainer_cls=OSMETrainer)
