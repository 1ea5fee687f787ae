"""ProtoTree (reference ``Examples/ProtoTreeNet.py``,
``configs/ProtoTreeNet.yaml``): a gradient step on the backbone, the neck
and the prototypes, then the derivative-free leaf update, every batch.

* the leaf update (``losses/prototree.leaf_update``) runs under ``no_grad``
  after the optimizer's step, from the forward's ``pa_leaf``, ``leaf_dist``
  and ``pred``, against ``old / len(train loader)``: the leaves as they
  were at the epoch's start. ``step_extras`` takes that snapshot once per
  epoch, also for a caller that drives ``train_step_call`` without the
  epoch hook;
* for ``epoch < FREEZE_EPOCHS`` (30) the backbone's gradients are zeroed
  (``transform_grads``); the neck and the prototypes train. The frozen
  parameters still take their AdamW step with zero gradients, as optax
  does, so Adam's step count matches the JAX package's once the gate opens;
* ``model.backbone.pretrain`` is read by the base Trainer.
"""

import torch

from ..engine import Trainer
from ..losses.prototree import leaf_update
from ..parallel import all_reduce_sum
from ..train import main


class ProtoTreeTrainer(Trainer):
    FREEZE_EPOCHS = 30

    def _refresh_step_inputs(self):
        num_batches = max(len(self.dataloaders["train"]), 1)
        self._old_leaf_over_batches = self.model.dist_params.detach() / num_batches
        self._step_inputs_epoch = self.epoch

    def on_start_epoch(self):
        super().on_start_epoch()
        self._refresh_step_inputs()

    def step_extras(self):
        """The leaves' epoch-start snapshot over the batch count, taken anew
        whenever the epoch has changed since the last one."""
        if getattr(self, "_step_inputs_epoch", None) != self.epoch:
            self._refresh_step_inputs()
        return self._old_leaf_over_batches

    def forward_train(self, batch):
        loss, outputs = super().forward_train(batch)
        self._leaf_inputs = (outputs["pa_leaf"].detach(), outputs["leaf_dist"].detach(),
                             outputs["pred"].detach(), batch["label"])
        return loss, outputs

    def transform_grads(self, batch):
        if self.epoch < self.FREEZE_EPOCHS:
            for p in self.model.backbone.parameters():
                if p.grad is not None:
                    p.grad.zero_()

    def train_step_call(self, batch, lr):
        old = self.step_extras()
        metrics = super().train_step_call(batch, lr)
        with torch.no_grad():
            leaves = self.model.dist_params
            new = leaf_update(leaves, old, *self._leaf_inputs, leaves.shape[1])
            if self.world_size > 1:  # the update sums over the global batch
                kept = torch.clamp_min(leaves - old, 0.0)
                new = kept + all_reduce_sum(new - kept)
            leaves.copy_(new)
        self._leaf_inputs = None
        return metrics


if __name__ == "__main__":
    main(trainer_cls=ProtoTreeTrainer)
