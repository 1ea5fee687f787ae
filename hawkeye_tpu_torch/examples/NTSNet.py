"""NTS-Net (reference ``Examples/NTSNet.py``, ``configs/NTSNet.yaml``): the
base Trainer's lifecycle, with the recipe's Adam and warm-up cosine; the
train forward takes the Trainer's ``model_generator`` for its dropout
masks. The proposals, NMS and part crops run on the device inside the step
(``models/methods/ntsnet.py``)."""

from ..engine import Trainer
from ..train import main


class NTSNetTrainer(Trainer):
    def apply_model(self, batch, train):
        if not train:
            return self.model(batch["img"])
        return self.model(batch["img"], generator=self.model_generator())


if __name__ == "__main__":
    main(trainer_cls=NTSNetTrainer)
