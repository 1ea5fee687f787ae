"""API-Net (reference ``Examples/APINet.py``, ``configs/APINet.yaml``):
P x K balanced train batches; the train forward takes the labels (and the
per-sample weights, where a batch has them) for its in-batch pair mining,
and the Trainer's ``model_generator`` for its dropout masks.

The epoch-0 backbone freeze (reference ``Examples/APINet.py:86-95``, which
sets the backbone group's LR to 0 for the first epoch) is
``transform_grads``: while ``epoch == 0`` it zeroes the ``.grad`` of every
``backbone.*`` parameter. The optimizer still applies the recipe's coupled
L2 (Adam, ``weight_decay`` 2e-8) to those parameters, so in epoch 0 the
backbone moves by its decay alone, as in the JAX package, whose gate
multiplies the gradients by 0 before optax adds the decay."""

from ..train import main
from .OSMENet import BalancedSamplerTrainer


class APINetTrainer(BalancedSamplerTrainer):
    def __init__(self, config=None, device=None):
        super().__init__(config, device)
        self._backbone_params = [p for n, p in self.model.named_parameters()
                                 if n.startswith("backbone.")]

    def apply_model(self, batch, train):
        if not train:
            return self.model(batch["img"])
        return self.model(batch["img"], labels=batch["label"],
                          weight=batch.get("weight"),
                          generator=self.model_generator())

    def transform_grads(self, batch):
        if self.epoch == 0:
            for p in self._backbone_params:
                if p.grad is not None:
                    p.grad.zero_()


if __name__ == "__main__":
    main(trainer_cls=APINetTrainer)
