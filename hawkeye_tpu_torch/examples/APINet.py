"""API-Net (reference ``Examples/APINet.py``, ``configs/APINet.yaml``):
P x K balanced train batches; the train forward takes the labels (and the
per-sample weights, where a batch has them) for its in-batch pair mining,
and a ``torch.Generator`` on the device for its dropout masks, seeded
from ``experiment.seed`` and the step (as the JAX step folds the step into
its key), so a resumed run draws what the uninterrupted one would have.

The epoch-0 backbone freeze (reference ``Examples/APINet.py:86-95``, which
sets the backbone group's LR to 0 for the first epoch) is
``transform_grads``: while ``epoch == 0`` it zeroes the ``.grad`` of every
``backbone.*`` parameter. The optimizer still applies the recipe's coupled
L2 (Adam, ``weight_decay`` 2e-8) to those parameters, so in epoch 0 the
backbone moves by its decay alone, as in the JAX package, whose gate
multiplies the gradients by 0 before optax adds the decay."""

import torch

from ..train import main
from .OSMENet import BalancedSamplerTrainer


class APINetTrainer(BalancedSamplerTrainer):
    def __init__(self, config=None, device=None):
        super().__init__(config, device)
        self.dropout_generator = torch.Generator(device=self.device)
        self._backbone_params = [p for n, p in self.model.named_parameters()
                                 if n.startswith("backbone.")]

    def apply_model(self, batch, train):
        if not train:
            return self.model(batch["img"])
        # bit 63 keeps the stream apart from the augmentation's seeds
        self.dropout_generator.manual_seed(
            (self.seed * 2**32 + self.step) | 1 << 63)
        return self.model(batch["img"], labels=batch["label"],
                          weight=batch.get("weight"),
                          generator=self.dropout_generator)

    def transform_grads(self, batch):
        if self.epoch == 0:
            for p in self._backbone_params:
                if p.grad is not None:
                    p.grad.zero_()


if __name__ == "__main__":
    main(trainer_cls=APINetTrainer)
