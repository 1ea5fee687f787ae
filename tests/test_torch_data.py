"""The port's own copies of the host data path (hawkeye_tpu_torch/data)
against the JAX package's: the same seeds give the same items, batches and
orders, and the port's Trainer trains from real JPEG files on disk (the
committed fixture tree) on the CPU."""

import torch_threads  # noqa: F401  (PyTorch's thread count: see the module)
import os
import random

import numpy as np
import pytest

from hawkeye_tpu import data as jax_data
from hawkeye_tpu.config import ConfigNode as JaxConfigNode
from hawkeye_tpu_torch import data as port_data
from hawkeye_tpu_torch.config import ConfigNode

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.join(HERE, "fixtures", "images")
META = os.path.join(HERE, "fixtures", "meta")
TCFG = {"image_size": 64, "resize_size": 72}


@pytest.mark.parametrize("split", ["train", "val"])
def test_fgdataset_items_match_jax(split):
    port_t = port_data.build_transforms(ConfigNode(TCFG))
    jax_t = jax_data.build_transforms(JaxConfigNode(TCFG))
    k = 0 if split == "train" else 1
    port_ds = port_data.FGDataset(ROOT, os.path.join(META, "train.txt"),
                                  transform=port_t[k])
    jax_ds = jax_data.FGDataset(ROOT, os.path.join(META, "train.txt"),
                                transform=jax_t[k])
    assert len(port_ds) == len(jax_ds) == 40
    assert port_ds.num_classes == jax_ds.num_classes
    for i in (0, 7, 39):
        random.seed(i)
        a = port_ds[i]
        random.seed(i)
        b = jax_ds[i]
        assert a["label"] == b["label"]
        np.testing.assert_array_equal(a["img"], b["img"])


def test_synthetic_samplers_and_loader_match_jax():
    port_ds = port_data.SyntheticDataset(24, 5, 16)
    jax_ds = jax_data.SyntheticDataset(24, 5, 16)
    np.testing.assert_array_equal(port_ds.labels, jax_ds.labels)
    port_s = port_data.RandomBatchSampler(24, 5, drop_last=True, seed=3)
    jax_s = jax_data.RandomBatchSampler(24, 5, drop_last=True, seed=3)
    port_s.set_epoch(2)
    jax_s.set_epoch(2)
    assert [list(b) for b in port_s] == [list(b) for b in jax_s]
    assert len(port_s) == len(jax_s) == 4
    seq = port_data.SequentialBatchSampler(24, 5)
    assert [len(b) for b in seq] == [5, 5, 5, 5, 4]
    loader = port_data.DataLoader(port_ds, port_s, num_workers=2)
    ref = jax_data.DataLoader(jax_ds, jax_s, num_workers=0)
    for a, b in zip(loader, ref):
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(a[key], b[key])
    balanced = port_data.BalancedBatchSampler(port_ds.labels, 2, 2, seed=1)
    ref_bal = jax_data.BalancedBatchSampler(jax_ds.labels, 2, 2, seed=1)
    assert [list(b) for b in balanced] == [list(b) for b in ref_bal]


def test_trainer_on_real_jpegs(tmp_path):
    import hawkeye_tpu_torch.models  # noqa: F401
    from hawkeye_tpu_torch.engine import Trainer

    cfg = ConfigNode({
        "experiment": {"name": "files", "log_dir": str(tmp_path), "seed": 0},
        "dataset": {"name": "fixtures", "root_dir": ROOT, "meta_dir": META,
                    "batch_size": 8, "num_workers": 2, "transformer": TCFG},
        "model": {"name": "BCNN", "backbone": "vgg11", "num_classes": 8,
                  "stage": 1},
        "train": {"epoch": 1, "criterion": {"name": "CrossEntropyLoss"},
                  "optimizer": {"name": "SGD", "lr": 0.1, "momentum": 0.9}},
    }).freeze()
    t = Trainer(cfg, device="cpu")
    assert len(t.datasets["train"]) == 40
    t.train()
    assert t.step == 5
    assert np.isfinite(t.performance_meters["train"]["loss"].values[-1])
    assert os.path.exists(os.path.join(t.log_root, "best_model.pt"))
