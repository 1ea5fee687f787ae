"""One rank of the two-process data-parallel train step that
test_torch_parallel.py holds against the JAX Trainer.

    python tests/torch_ddp_worker.py RANK WORLD PORT CONFIG INIT BATCH OUT

Joins a gloo process group at ``tcp://127.0.0.1:PORT``, builds the port's
Trainer from ``CONFIG`` on the CPU with ``F64Net`` (the tests' ``TINY``
trunk, one BasicBlock per stage, and a linear head on the spatial mean of
its last stage, all in float64), loads the state dict
``INIT``, takes its rank's rows of the global batch in ``BATCH`` (an
``.npz``) and runs one train step; writes the model's state dict and the
step's metrics to ``OUT/rank<RANK>.pt``. Imports no JAX."""

import datetime
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from hawkeye_tpu_torch import BACKBONE  # noqa: E402
from hawkeye_tpu_torch.config import setup_config  # noqa: E402
from hawkeye_tpu_torch.engine import Trainer  # noqa: E402
from hawkeye_tpu_torch.models.backbones import resnet  # noqa: E402

TINY = "resnet10"


def tiny(num_classes=0, **kw):
    return resnet.ResNet(resnet.BasicBlock, (1, 1, 1, 1), num_classes=num_classes, **kw)


class F64Net(torch.nn.Module):
    """The ``TINY`` trunk and a linear head on the mean of its ``c5``, in
    float64 throughout (the Baseline's ``pool`` is float32 in both
    packages)."""

    def __init__(self, num_classes):
        super().__init__()
        self.backbone = BACKBONE.get(TINY)(dtype=torch.float64)
        self.fc = torch.nn.Linear(self.backbone.out_channels, num_classes)
        self.double()

    def forward(self, x):
        return {"logits": self.fc(self.backbone(x)["c5"].mean(dim=(1, 2)))}


class PortF64Trainer(Trainer):
    def get_tb_writer(self):
        return None

    def get_model(self, model_config):
        return F64Net(int(model_config.num_classes))


def main(rank, world, port, config, init, batch, out):
    torch.set_num_threads(1)
    BACKBONE.register(tiny, name=TINY)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    try:
        trainer = PortF64Trainer(setup_config(["--config", config]), device="cpu")
        trainer.model.load_state_dict(torch.load(init))
        data = dict(np.load(batch))
        per = len(data["label"]) // world
        local = {k: v[rank * per:(rank + 1) * per] for k, v in data.items()}
        # the rate in float32, as the JAX step takes it
        lr = float(np.float32(trainer.config.train.optimizer.lr))
        m = trainer.train_step_call(trainer.prepare_batch(local, train=True), lr)
        torch.save({"state": trainer.model.state_dict(),
                    "metrics": {k: float(v) for k, v in m.items()},
                    "cross_replica": all(b.cross_replica for b in trainer.model.modules()
                                         if hasattr(b, "cross_replica")),
                    "world": (trainer.rank, trainer.world_size)},
                   os.path.join(out, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    r, w, p = (int(a) for a in sys.argv[1:4])
    main(r, w, p, *sys.argv[4:8])
