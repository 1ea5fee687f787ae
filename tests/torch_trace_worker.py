"""One rank of the two-process traced train steps that test_torch_trace.py
counts.

    python tests/torch_trace_worker.py RANK WORLD PORT LOGDIR OUT

Joins a gloo process group at ``tcp://127.0.0.1:PORT``, builds the port's
Trainer on the CPU (ResNet-18 in float32 at 32x32, synthetic data, a global
batch of 8 over the ranks), and runs two train steps of its rank's rows
with a ``torch.profiler`` recording. Writes the tracer's summary, each
span's parent (``parents``), the model's BatchNorm widths and its
parameter count to ``OUT/rank<RANK>.json``. Imports no JAX."""

import datetime
import json
import os
import sys

import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import hawkeye_tpu_torch.models  # noqa: E402,F401  (registry side effects)
from hawkeye_tpu_torch.config import ConfigNode  # noqa: E402
from hawkeye_tpu_torch.engine import Trainer  # noqa: E402
from hawkeye_tpu_torch.models.backbones.norm import BatchNorm  # noqa: E402
from hawkeye_tpu_torch.utils import trace  # noqa: E402

STEPS = 2


def parents(events):
    """{(span, the span around it or None)} of the profiler's ``events``:
    the innermost span (``trace.ranges``), on any thread, whose interval
    holds the span's (the backward's nodes run on the autograd engine's)."""
    ranges = trace.ranges(events)
    out = set()
    for a, b, name, _ in ranges:
        around = [(d - c, n) for c, d, n, _ in ranges
                  if c <= a and b <= d and (c, d) != (a, b)]
        out.add((name, min(around)[1] if around else None))
    return out


def tiny_config(log_dir, name, length=8, batch=4, workers=0):
    """ResNet-18 in float32 at 32x32 on synthetic data, SGD."""
    return ConfigNode({
        "experiment": {"name": name, "log_dir": str(log_dir), "seed": 0, "debug": True},
        "dataset": {"name": "synthetic", "length": length, "batch_size": batch,
                    "num_workers": workers,
                    "transformer": {"image_size": 32, "resize_size": 36}},
        "model": {"name": "ResNet18", "num_classes": 4, "dtype": "float32"},
        "train": {"epoch": 1, "optimizer": {"name": "SGD", "lr": 0.01, "momentum": 0.9},
                  "scheduler": {"name": "CosineAnnealingLR", "T_max": 1},
                  "criterion": {"name": "CrossEntropyLoss"}},
    }).freeze()


class QuietTrainer(Trainer):
    """No TensorBoard writer (closing one holds a test for seconds)."""

    def get_tb_writer(self):
        return None


def main(rank, world, port, log_dir, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    try:
        trainer = QuietTrainer(tiny_config(log_dir, "trace", length=8 * STEPS, batch=8),
                               device="cpu")
        batches = list(trainer.dataloaders["train"])[:STEPS]
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            trace.reset()
            for b in batches:
                trainer.train_step_call(trainer.prepare_batch(b, train=True), 0.01)
        events = prof.events()
        widths = [m.weight.numel() for m in trainer.model.modules()
                  if isinstance(m, BatchNorm)]
        params = sum(p.numel() for p in trainer.model.parameters())
        with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
            json.dump({"summary": trace.summary(events), "parents": list(parents(events)),
                       "bn_widths": widths, "params": params,
                       "rows": [len(b["label"]) for b in batches]}, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    r, w, p = (int(a) for a in sys.argv[1:4])
    main(r, w, p, *sys.argv[4:6])
